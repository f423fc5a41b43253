#!/usr/bin/env python3
"""Time the bf16 attention, resblock-chain and AdaLN FFN kernels, the int8
product, the quantize pass, the LayerNorm with the AdaLN modulation, the
conv kernel and the linear kernel of the PyTorch port against design
variants on one CUDA card: the measurements behind the design choices
stated in the headers of supertonic_tpu_torch/csrc/attention.cu,
resblock_chain.cu, ffn.cu, int8_matmul.cu, quantize.cu, ln_modulate.cu,
conv1d.cu and linear.cu.

    python3 kernel_variants.py                 # every kernel
    python3 kernel_variants.py ffn attention   # some of them (attention_f32:
                                               # the f32 attention)
    python3 kernel_variants.py resblock_chain quantize --split  # and the
                                               # time splits (SPLIT)
    python3 kernel_variants.py linear w8a8_forms --split --residual
                                               # the residual forms alone
    python3 kernel_variants.py linear --bias   # the bias form's instances

Each variant is the kernel's own source with design constants changed by
text substitution in its bf16 section, or a whole source file: for
"earlier" the design the committed kernel replaced
(supertonic_tpu_torch/csrc/earlier/), for the chain's clusters a design
alternative (supertonic_tpu_torch/csrc/variants/), built with
the package's nvcc flags into supertonic_tpu_torch/build/variants/
(ptxas's register and spill report printed), checked against the plain
PyTorch version and timed in turns with the kernel as committed
(committed, variants, variants in reverse, committed), at the shapes one
b64/5-step batch gives each kernel (chip_smoke.py records them) and, for
all three, at the B=1 shapes of a streamed chunk (the chain: the two
vocoder windows; the int8 product and the quantize pass: the b64 batch's
shapes and the TP int8 batch's). Each is timed twice: launched from the host (CUDA events
around the calls, as chip_smoke.py times them) and replayed from a CUDA
graph of the same calls, as the engine runs them, which leaves out the
host's per-call work:
  attention  the whole-row form (bf16 Dh 64, Tk up to ROW_KEYS) at the b64
             cell's and a streamed chunk's shapes: the two-pass design it
             replaced (earlier) and the mma.sync design before that
             (earlier); from csrc/variants/, the form as first built (key
             tiles of 64, S a product group a tile, Tk padded to 128), with
             S in product groups of 64 keys (also with K and V waited for
             chunk by chunk), and with the next tile's S products beside a
             tile's output; a third or a quarter of the exponentials by a
             polynomial on the FMA pipe; one query tile a block (K and V
             loaded for each); with --split the form
             without its S products, its exponentials, its P.V products,
             the exchange of the partial O's or its stores, and the two-pass
             design without pass 1's products and exponentials, without
             pass 1 (nor its K loads), without pass 2's S products, the
             exponentials, P.V or the stores (unchecked); beside SDPA
             (a yardstick)
  attention_f32  the f32 kernel with instances at Dh 32-128 that the
             SIMT kernel of any width replaced (earlier), at Dh 64 and 128
  chain      the designs it replaced (earlier: two m64n64k16 products a
             k-step and the epilogue in f32; the mma.sync design); the
             epilogue in f32; two m64n64k16 products a k-step; the replaced
             design with the committed epilogue; clusters of 2 and of 4
             blocks on neighbouring tiles with each weight stage multicast
             by TMA into all of them (on the replaced design); the accurate
             silu (expf and IEEE division); half of silu's exponentials by
             a polynomial on the FMA pipe; the largest tile at every shape
             (no smaller tiles for a grid that does not fill the card); two
             consumer warpgroups at every C; no stages of 64 input
             channels; the conv size at run time only; with --split, on the
             committed kernel and on the replaced design: silu as the
             identity, no epilogue, no products, no conv-boundary barrier,
             no weight stages (none loaded nor waited for), the products
             alone, the window's load and store alone (unchecked)
  int8       the W8A8 product (bf16 results) at the b64 cell's shapes and the
             int32 form at the TP int8 path's and the cell's, beside
             torch._int_mm (the product alone, a yardstick): the mma.sync
             design it replaced (earlier); the silu form by the exact
             sequence a value (no silu table); 64 x 256 tiles a consumer; 3 ring
             stages; not persistent; stores from the registers (no TMA
             store); 128 x 256 tiles shared by the two consumers; and the
             silu form at the ffn.in shape, its instance on 128 x 128 tiles
             of two consumer warpgroups or 64 x 128 of three
  quantize   the one-warp-a-row design it replaced (earlier); persistent
             blocks whose warps walk rings of 1-4 KB stages (the design
             first built for it, csrc/variants/); 4 KB or 1 KB of rows a
             warp; 8 warps a block; and with --split: loads only (the rows
             staged, nothing computed or stored), loads and each row's max
             (no division, no xq), a product with 1 / sx for the IEEE
             division (not bit-equal), and the earlier design's loads and
             max alone, at the cell's shapes, the TP shapes and at M from
             7,168 to 57,344
  ln_modulate  the one-warp-a-row design it replaced (earlier), with and
             without the modulation; 2 and 4 row slots a warp; and with
             --split: loads only (rows staged and summed, no statistics
             or stores), in this design and in the earlier one; beside
             F.layer_norm at the plain LayerNorm's shape
  ln_quantize  the LayerNorm's quantizing form (the int8 path's ln1, ln2,
             ln3) at the int8 cell's and a streamed chunk's shapes, with
             each quotient by __fdiv_rn (no row reciprocal), beside the pair
             it replaced (the LayerNorm, then the quantize pass)
  silu_quantize  the W8A8 FFN-in's silu-quantize form at the int8 cell's and
             a streamed chunk's shapes, first at every finite bf16 value
             (chip_smoke.siluq_every_bf16): the design it replaced
             (earlier: 64 x 256 tiles in clusters of 8, two consumers, the
             exact silu sequence a value); the exact sequence on the
             committed tiles (no silu table); each quotient by __fdiv_rn;
             four or two consumers; 64 x 256 tiles in clusters of 8 with
             the table, or with the exact sequence; beside the pair it
             replaced (the W8A8 silu form, then the quantize pass) and the
             silu form alone, with the edge rows and without them (every
             value on the table's fast path), and on the int8 network's own
             FFN-in operands (chip_smoke.py's weights, one b64/5-step
             batch); with --split: silu as the identity, no quantize (the
             bf16 values' high bytes stored), no cluster exchange (each
             row's amax over its own tile), no stores, the table's lookups
             without bank conflicts, and the first four on the replaced
             design (unchecked); then the bf16 linear's silu
             form (the table where its tiles hold it) beside the builds
             whose silu is the exact sequence
  conv1d     the conv kernel at the b64 cell's shapes: the one-tile-a-block
             design it replaced (earlier), and that design with A in
             registers (csrc/variants/); every tile staging its own
             windows (a silu for each column tile); 3 ring stages; the
             epilogue's options read at run time (one instance for every
             call); the masked convs in turns everywhere, or cooperative
             everywhere; the pre_res instances cooperative; the prenet's
             and the head's in turns; the head with 11 staging warps; with --split:
             no products, no silu in the staging, no epilogue, the epilogue
             without its residual loads or its stores (unchecked); beside
             F.conv1d (the bare conv, a yardstick)
  linear     the linear kernel at the b64 cell's shapes (each bias, silu and
             tail form): the replaced design (earlier); silu by a fast
             quotient where a guard finds it exact and the exact sequence in
             a second pass elsewhere (csrc/variants/); 128 x 128 tiles with
             4 ring stages, stored from the registers with 6, or 128 x 256
             tiles shared by both consumers; the silu
             form on 64 x 64 (four consumer warpgroups), 128 x 128 (two),
             64 x 128 (three), 128 x 64 (four), 64 x 256 (two) or shared
             128 x 256 tiles; the bias form on 64 x 128 tiles of four; the
             bias form on each instance's tiles at every shape, and on
             other tiles where it takes 128 x 128 ones (with --bias alone:
             the bias form's shapes of the b64 cell and of a streamed chunk,
             beside F.linear); the
             tail's x_in read from device memory, or 64 x 128 tail tiles;
             with --split: no epilogue math, no products, no stores, and
             loads only (unchecked); beside F.linear(x, w, b)
             (cuBLAS's product with its bias epilogue, a yardstick) and the
             route it replaced (cuBLAS's product, then the bias cast and add,
             silu or the flow step's four elementwise passes); first the
             silu form at every finite bf16 value. Then the Q and K
             projections' rope form and the O and FFN-out projections'
             residual form at the cell's and a streamed chunk's shapes,
             beside the pair each replaced (F.linear, then the bias-and-rope
             or gated-residual kernel) and the bias form alone: the rope
             form's replaced design (earlier: cos and sin from device memory
             in the epilogue), that design on 64 x 128 tiles of three
             consumers, the committed design (the angles by TMA into the
             output buffer) on 64 x 128 tiles of three, on 64 x 256 tiles
             (four heads a tile), on 64 x 128 tiles of four, and at a
             streamed chunk's M on 64 x 128 tiles of one consumer (not
             Few's 64 x 64, whose buffer cannot hold the angles), and with
             its cos and sin staged in
             shared memory (csrc/variants/) on four tile shapes; the residual
             form in 64 x 128 tiles of four consumer warpgroups, or stored
             from the registers (the residual from device memory), and at a
             streamed chunk's shapes on the bias form's 64 x 32 tiles from
             the registers; the residual form's replaced design (earlier:
             its gated residual and bias add by f32 operations a value);
             the residual form's gated residual or bf16 bias add by f32
             operations, on 128 x 128 tiles of two consumers or 64 x 128 of
             four, and the alternatives of csrc/variants/
             linear_resid_next_tile.cu (the next tile's residual loaded
             behind the epilogue; W resident, or shared by a 2-block
             cluster); with --split also the rope form without its
             rotation (the bias forms stored; the cos and sin loads may go
             with it) or without its cos and sin loads, the residual form
             without its residual loads, its gate loads, W's loads after a
             block's first tile or X's (the products run on the stages the
             first tile left), and as the product alone (its bias form: no
             residual or gate loads) on its own tiles and on 128 x 128
             tiles of two consumers; with --residual the residual forms
             alone (their shapes, variants and splits)
  w8a8_forms the W8A8 product's rope and residual forms (also run with
             int8) at the int8 cell's and a streamed chunk's shapes beside
             the pair each replaced and the product alone: the rope form's
             replaced design (earlier), the committed design (the angles by
             TMA) on the replaced design's 64 x 128 tiles of three
             consumers, on 64 x 128 tiles of two, on 128 x 128 tiles with 5
             ring stages and the weight scales from device memory, and at a
             streamed chunk's M on 64 x 128 tiles of one; the residual form's
             replaced design (earlier), and it on 128 x 128 tiles of two or
             64 x 128 of four; with --split the linear kernel's splits of
             the two forms (the residual form's: without its residual, gate,
             W or X loads, without its epilogue math, products or stores,
             and the product alone on its tiles and on 128 x 128 tiles)
  ffn        the mma.sync design it replaced (earlier); silu by
             __fdividef, or with its reciprocal by Newton's method; one
             tile a consumer
             warpgroup (not persistent); stores from the registers; GEMM1
             in 64 x 256 tiles a consumer; 3 ring stages; 128 x 256
             tiles shared by the two consumers; at few rows GEMM2 in 64 x
             64 tiles; and a torch.profiler split of the committed FFN's
             launches
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from supertonic_tpu_torch.ops import (_build, attention, conv1d, ffn, gated_residual,
                                      int8_matmul, linear, ln_modulate, quantize, rope,
                                      vocoder_fused, w8a8)
from supertonic_tpu_torch.ops.gated_residual import batch_rows

BF16_SECTION = "// bf16 on the tensor cores"
FILE = "file"  # a variant that is a whole source file under csrc/ (+ substitutions)
# the quantize pass's per-value arithmetic, which quantize.cu includes (a
# split substitutes it in place of the include)
QUANTIZE8 = (_build.CSRC_DIR / "quantize8.cuh").read_text()
# the silu table's header, which linear.cu includes (a split substitutes it)
SILU_TABLE = (_build.CSRC_DIR / "silu_table.cuh").read_text()
CLUSTER_SRC = "variants/resblock_chain_cluster.cu"
CHAIN_ACC = [("stk::silu_fast(", "stk::silu_f(")]
# half the exponentials of the chain's silu on the FMA pipe: 2^y = 2^n 2^f,
# n = rint(y), 2^f by its degree-5 Taylor polynomial on |f| <= 1/2
CHAIN_POLY = [(
    "  return stk::pack_bf16(stk::silu_fast(a), stk::silu_fast(b));",
    "  const float y = fminf(fmaxf(-1.4426950408889634f * a, -126.0f), 126.0f);\n"
    "  const float r = y + 12582912.0f, f = y - (r - 12582912.0f);\n"
    "  float p = fmaf(1.3333558e-3f, f, 9.6181291e-3f);\n"
    "  p = fmaf(fmaf(fmaf(fmaf(p, f, 5.5504109e-2f), f, 2.4022651e-1f), f, 6.9314718e-1f), f,"
    " 1.0f);\n"
    "  const float e = __int_as_float(__float_as_int(p) + ((__float_as_int(r) - 0x4B400000)"
    " << 23));\n"
    "  return stk::pack_bf16(__fdividef(a, 1.0f + e), stk::silu_fast(b));")]
# Deliberately incomplete chain kernels, timed beside the committed one to
# split where its time goes, and never checked (their outputs are wrong):
# python3 kernel_variants.py resblock_chain --split
CHAIN_EPILOGUE = "    const bool last = conv == 2 * P - 1;\n"
# the linear kernel's splits: the epilogue returns the sums as they are; the
# products are skipped; the results go to one address (the TMA stores are
# skipped; the buffer writes and the math stay)
LIN_MANY = "using Many = Tile<2, 2, 128, 5, 1, false, true, 2>;"
LIN_SILUQ = "using SiluQ = Tile<3, 1, 128, 8, 1, false, true, 1, 4>;"
# silu by the exact sequence a value instead of the block's table
SILU_EXACT = [("constexpr bool SILU_BY_TABLE = true;", "constexpr bool SILU_BY_TABLE = false;")]
LIN_MANY_SILU = "using ManySilu = Tile<4, 1, 128, 5, 1, false, true, 2>;"
LIN_TAIL = "using TailTile = Tile<2, 1, 96, 6, 1, false, true, 4>;"
LIN_RESID = ("using ManyResid = Tile<3, 1, 128, 7, 1, false, true, 2>;  // the residual form at "
             "many tiles")
# the residual form on 128 x 128 tiles of two consumers, 4 ring stages
RESID_ON_MANY = (LIN_RESID, "using ManyResid = Tile<2, 2, 128, 4, 1, false, true, 2>;")
# variants of the committed residual form: the gated residual, and the bf16
# bias add, by f32 operations a value (epi_pair's, not packed bf16); 64 x
# 128 tiles of four consumers; the design alternatives of
# csrc/variants/linear_resid_next_tile.cu (the next tile's residual loaded
# behind the epilogue; W resident where K <= 512 and a 2-block cluster along
# M sharing each W stage beyond, routed by a substitution in its pick)
RESID_NEXT_SRC = "variants/linear_resid_next_tile.cu"
RESID_F32 = [("  return bits2(__hadd2_rn(bf2(x), __hmul2_rn(bf2(g), bf2(o))));",
              "  const float2 ov = unpack(o), xv = unpack(x), gv = unpack(g);\n"
              "  const float2 go = bf16_pair(__fmul_rn(gv.x, ov.x), __fmul_rn(gv.y, ov.y));\n"
              "  return stk::pack_bf16(__fadd_rn(xv.x, go.x), __fadd_rn(xv.y, go.y));")]
RESID_BIAS_F32 = [("  return bits2(__hadd2_rn(bf2(stk::pack_bf16(v0, v1)), bf2(bw)));",
                   "  return bias_pair(v0, v1, b);")]
RESID_SHARED_W = [(
    "    return mode == MODE_SILU ? I_MANY_SILU : mode == MODE_RESID ? I_RESID_MANY : I_MANY;",
    "    return mode == MODE_SILU ? I_MANY_SILU\n"
    "           : mode != MODE_RESID ? I_MANY\n"
    "           : K <= RESID_W_K && (N + ResidW::BN - 1) / ResidW::BN <= sms ? I_RESID_W\n"
    "                                                                   : I_RESID_PAIR;")]
RESID_VARIANTS = {
    "the residual form's gated residual by f32 operations a value (not packed bf16)": RESID_F32,
    "the residual form's bf16 bias add by f32 operations a value (not packed bf16)":
        RESID_BIAS_F32,
    "the residual form on 128 x 128 tiles, two consumers, 4 ring stages": [RESID_ON_MANY],
    "the residual form on 64 x 128 tiles, four consumers, 5 ring stages": [
        (LIN_RESID, "using ManyResid = Tile<4, 1, 128, 5, 1, false, true, 2>;")],
    "the residual form's next tile's residual, bias and gate loaded behind its epilogue (a "
    "residual buffer of its own, 5 ring stages)": (FILE, RESID_NEXT_SRC, []),
    "the residual form with W resident at K up to 512, else a 2-block cluster along M sharing "
    "each W stage": (FILE, RESID_NEXT_SRC, RESID_SHARED_W)}
LIN_ROPE = ("using RopeMany = Tile<2, 2, 128, 5, 1, false, true, 2>;   // the rope form at Dh 16, "
            "32, 64, 128")
LIN_ROPE8 = "using RopeMany8 = Tile<2, 2, 128, 4, 1, false, true, 2>;"
# the rope form without its angles: neither the TMA loads into the output
# buffer nor the reads from it (nor, where a tile takes them from device
# memory, those loads); constants in their place
ROPE_NO_ANGLES = [
    ("            stk::mbar_arrive_tx(&xfull[wg], 2 * S::ROWS * 128);\n"
     "            stk::tma_load_2d(buf, &tm_xin, &xfull[wg], 0, m0);\n"
     "            stk::tma_load_2d(buf + S::ROWS * 128, &tm_sn, &xfull[wg], 0, m0);\n",
     "            stk::mbar_arrive_tx(&xfull[wg], p.K < 0 ? 2 * S::ROWS * 128 : 0);\n"
     "            if (p.K < 0) stk::tma_load_2d(buf, &tm_xin, &xfull[wg], 0, m0);\n"
     "            if (p.K < 0)\n"
     "              stk::tma_load_2d(buf + S::ROWS * 128, &tm_sn, &xfull[wg], 0, m0);\n"),
    ("                cvs[q] = *reinterpret_cast<const float2*>(at);\n"
     "                svs[q] = *reinterpret_cast<const float2*>(at + S::ROWS * 128);\n",
     "                cvs[q] = p.K < 0 ? *reinterpret_cast<const float2*>(at)"
     " : make_float2(0.5f, 0.25f);\n"
     "                svs[q] = p.K < 0 ? *reinterpret_cast<const float2*>(at + S::ROWS * 128)"
     " : make_float2(0.25f, 0.5f);\n"),
    ("                const float2 cv = __ldg(reinterpret_cast<const float2*>(p.cs + ce));\n"
     "                const float2 sv = __ldg(reinterpret_cast<const float2*>(p.sn + ce));\n",
     "                const float2 cv = p.K < 0 ? __ldg(reinterpret_cast<const float2*>(p.cs + ce))"
     " : make_float2(0.5f, 0.25f);\n"
     "                const float2 sv = p.K < 0 ? __ldg(reinterpret_cast<const float2*>(p.sn + ce))"
     " : make_float2(0.25f, 0.5f);\n")]
# the rope form's replaced design: each angle pair from device memory (L2)
# in the epilogue, after the products
ROPE_EARLIER = "earlier/linear_rope_l2.cu"
# the rope form where Many's tiles would not fill the card (a streamed
# chunk's M) on 64 x 128 tiles of one consumer, whose output buffer holds
# the angles (brought by TMA), instead of Few's 64 x 64 (angles from L2)
ROPE_FEW_WIDE = [("    if (in == I_FEW) return launch_tiles<MODE, Few, 64, Q8>(x, w, p, st);",
                  "    if (in == I_FEW)\n"
                  "      return launch_tiles<MODE, Tile<1, 1, 128, 6, 1, false, true, 2>, 64, Q8>("
                  "x, w, p, st);")]
# the residual form's replaced design: its gated residual and bf16 bias add
# by f32 operations a value, on 64 x 128 tiles of three consumers everywhere
RESID_EARLIER = "earlier/linear_resid_f32_epilogue.cu"
ROPE_STAGED_SRC = "variants/linear_rope_staged.cu"
# the W8A8 forms' weight scales read from device memory (L1/L2) in the
# epilogue instead of staged in shared memory (which leaves RopeMany8's tiles
# room for a fifth ring stage); safe where the tiles' columns end at N (the
# VE's N 512)
W8A8_WS_GLOBAL = [
    ("         (Q8 ? (size_t)S::NC * 4 * S::BN : 0) +", "         0 +"),
    ("        if constexpr (Q8)\n"
     "          stk::cp_async4(stk::smem_u32(ws_s + c), p.ws + (n0 + c < p.N ? n0 + c : 0),\n"
     "                         n0 + c < p.N);\n", ""),
    ("                    wa = *reinterpret_cast<const float2*>(ws_s + 8 * j + 2 * t);",
     "                    wa = __ldg(reinterpret_cast<const float2*>(p.ws + n0 + 8 * j + 2 * t));"),
    ("                    wb = *reinterpret_cast<const float2*>(ws_s + 8 * jp + 2 * t);",
     "                    wb = __ldg(reinterpret_cast<const float2*>(p.ws + n0 + 8 * jp + 2 * t));"),
    ("            const float2 wv = Q8 ? *reinterpret_cast<const float2*>(ws_s + 8 * j + 2 * t)"
     " : bl;",
     "            const float2 wv = Q8 ? __ldg(reinterpret_cast<const float2*>("
     "p.ws + n0 + 8 * j + 2 * t)) : bl;"),
    ("          const float2 wv = Q8 ? *reinterpret_cast<const float2*>(ws_s + c) : bl;",
     "          const float2 wv = Q8 ? __ldg(reinterpret_cast<const float2*>(p.ws + n0 + c)) : bl;")]
LIN_GATE_STAGED = "              gsel[r][half] = at / p.T - b0;"
LINEAR_NO_MATH = [
    ("  const uint32_t o = bias_pair(v0, v1, b);\n  if constexpr (MODE == MODE_BIAS) {",
     "  if (dt != 12345.0f) {\n"
     "    if constexpr (MODE == MODE_TAIL)\n"
     "      return make_uint2(__float_as_uint(v0), __float_as_uint(v1));\n"
     "    else\n"
     "      return stk::pack_bf16(v0, v1);\n"
     "  }\n"
     "  const uint32_t o = bias_pair(v0, v1, b);\n  if constexpr (MODE == MODE_BIAS) {")]
LINEAR_NO_PRODUCTS = [("stk::Wgmma<BN>::template ss<0>(acc[r],",
                       "if (p.K < 0) stk::Wgmma<BN>::template ss<0>(acc[r],")]
# the residual form's splits of its operands' traffic (unchecked): the
# products of a block's later tiles run on the W (or X) its ring stages hold
# from its first tile, so those tiles load no W (or X) through L2; the
# product alone on the residual form's tiles (its bias form there: neither
# residual nor gate loads), and on 128 x 128 tiles of two consumers
RESID_LOADS = (
    "          stk::mbar_arrive_tx(&full[s], S::STEP);\n"
    "          stk::tma_load_2d(stage_a(s), &tm_x, &full[s], kt * KE, m0);\n"
    "          if constexpr (S::WRS == 0) stk::tma_load_2d(stage_w(s), &tm_w, &full[s], kt * KE, "
    "n0);\n")
RESID_NO_W = [(RESID_LOADS,
               "          const bool wl = i == 0 || MODE != MODE_RESID || p.K < 0;\n"
               "          stk::mbar_arrive_tx(&full[s], wl ? S::STEP : S::STAGE_A);\n"
               "          stk::tma_load_2d(stage_a(s), &tm_x, &full[s], kt * KE, m0);\n"
               "          if constexpr (S::WRS == 0)\n"
               "            if (wl) stk::tma_load_2d(stage_w(s), &tm_w, &full[s], kt * KE, n0);\n")]
RESID_NO_X = [(RESID_LOADS,
               "          const bool xl = i == 0 || MODE != MODE_RESID || p.K < 0;\n"
               "          stk::mbar_arrive_tx(&full[s], xl ? S::STEP : S::STEP - S::STAGE_A);\n"
               "          if (xl) stk::tma_load_2d(stage_a(s), &tm_x, &full[s], kt * KE, m0);\n"
               "          if constexpr (S::WRS == 0) stk::tma_load_2d(stage_w(s), &tm_w, &full[s], "
               "kt * KE, n0);\n")]
RESID_NO_RES_LOADS = [
    ("        if (tid == 0) {\n          stk::bulk_wait_read<0>();",
     "        if (tid == 0 && p.K < 0) {\n          stk::bulk_wait_read<0>();"),
    ("      if constexpr (IN_TMA) stk::mbar_wait(&xfull[wg], (i / NC) & 1);",
     "      if constexpr (IN_TMA) if (p.K < 0) stk::mbar_wait(&xfull[wg], (i / NC) & 1);")]
RESID_NO_GATE = [("                if (p.gate) {\n", "                if (p.gate && p.K < 0) {\n")]
# the residual form's epilogue stores the bias form, its gate rows unstaged
RESID_GATED = "                *at = gated_pair(resid_bias(v0, v1, bq, bw), *at, gw);\n"
RESID_BIAS_ONLY = [
    (RESID_GATED, "                *at = resid_bias(v0, v1, bq, bw);\n"),
    ("        if (p.gate)\n          for (int c = tid; c < BN; c += 128) {",
     "        if (p.gate && p.K < 0)\n          for (int c = tid; c < BN; c += 128) {")]
RESID_PRODUCT_ALONE = RESID_NO_RES_LOADS + RESID_NO_GATE + RESID_BIAS_ONLY
LINEAR_NO_STORES = [
    ("stk::tma_store_2d(&tm_y,", "if (p.K < 0) stk::tma_store_2d(&tm_y,"),
    ("              stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, p.N, v);",
     "              if (p.K < 0 || reinterpret_cast<const uint32_t&>(v) == 0x7fc00001u)\n"
     "                stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, p.N, v);")]
# the bias form's instances: each variant takes one of them at every shape
# (pick() in linear.cu) where N is a multiple of 8
LIN_PICK_BIAS = "  if (N % 8) return I_ANY_N;  // rows no TMA map takes\n"
BIAS_INSTANCES = (("128 x 128 tiles of two consumers (Many)", "I_MANY"),
                  ("64 x 128 tiles of four consumers (ManySilu)", "I_MANY_SILU"),
                  ("64 x 64 tiles, two blocks an SM (Few)", "I_FEW"),
                  ("64 x 32 tiles from the registers (AnyN)", "I_ANY_N"),
                  ("64 x 128 tiles of three consumers, 7 ring stages (ManyResid)",
                   "I_RESID_MANY"))


# the launch of the bias form on the silu or residual form's tiles (pick()
# gives it neither)
LIN_BIAS_DISPATCH = (
    "    if (in == I_MANY || in == I_MANY_SILU || in == I_RESID_MANY)\n",
    "    if constexpr (MODE == MODE_BIAS) {\n"
    "      if (in == I_MANY_SILU) return launch_tiles<MODE, ManySilu, 0, Q8>(x, w, p, st);\n"
    "      if (in == I_RESID_MANY) return launch_tiles<MODE, ManyResid, 0, Q8>(x, w, p, st);\n"
    "    }\n"
    "    if (in == I_MANY || in == I_MANY_SILU || in == I_RESID_MANY)\n")
# other tiles for the bias form's many-tile instance (Tile's arguments)
BIAS_MANY_TILES = (("128 x 64 tiles of two consumers in turns", "2, 2, 64, 6, 1, false, true, 2"),
                   ("64 x 256 tiles of two consumers in turns", "2, 1, 256, 3, 1, false, true, 2"),
                   ("64 x 128 tiles of two consumers in turns", "2, 1, 128, 6, 1, false, true, 2"),
                   ("64 x 128 tiles of three consumers in turns", "3, 1, 128, 6, 1, false, true, 2"),
                   ("64 x 128 tiles of one consumer, two blocks an SM",
                    "1, 1, 128, 3, 2, false, true, 2"),
                   ("64 x 64 tiles of three consumers in turns", "3, 1, 64, 8, 1, false, true, 2"))
LIN_FEW = "using Few = Tile<1, 1, 64, 6, 2, false, true, 2>;"


def replaced(text: str, old: str, new: str) -> str:
    """text with old replaced by new; raises where old is not in it."""
    if old not in text:
        raise RuntimeError(f"'{old}' not in the text")
    return text.replace(old, new)


# the silu-quantize form's splits (unchecked): silu as the identity (the
# rescaled bias form kept); no quantize (each bf16 value's high byte stored);
# no cluster exchange (each row's amax over the tile's own columns); no
# stores (the int8 tiles' TMA stores skipped)
SILUQ_SPLIT = {
    "split: silu as the identity (the table's lookups skipped)": [
        ("h[j][half] = stk::silu_bf16x2_table(silu_tab, h[j][half]);", ";")],
    "split: no quantize (the bf16 values' high bytes stored)": [
        ("const uint32_t q0 = (uint32_t)stk::quantize1(f.x, sc[half], rc[half]) & 0xffu;",
         "const uint32_t q0 = (h[j][half] >> 8) & 0xffu;"),
        ("const uint32_t q1 = (uint32_t)stk::quantize1(f.y, sc[half], rc[half]) & 0xffu;",
         "const uint32_t q1 = h[j][half] >> 24;")],
    "split: no cluster exchange (each row's amax over the tile's own columns)": [
        ("          for (int peer = t; peer < n_tiles; peer += 4)\n"
         "            stk::st_async_f32(",
         "          for (int peer = t; peer < n_tiles && p.K < 0; peer += 4)\n"
         "            stk::st_async_f32("),
        ("        stk::mbar_wait_cluster(&xbar[slot], (round >> 1) & 1);\n"
         "        if (tid == 0) stk::mbar_arrive_tx(&xbar[slot], n_tiles * S::ROWS * 4);\n", ""),
        ("          float amax = 0.0f;  // the row's four threads read every fourth block's\n"
         "          for (int peer = t; peer < n_tiles; peer += 4)\n"
         "            amax = fmaxf(amax, xch[(slot * SQ_BLOCKS + peer) * S::ROWS + rr]);\n"
         "          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));\n"
         "          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));\n",
         "          const float amax = am[half];\n")],
    "split: no stores (the int8 tiles' TMA stores skipped)": [
        ("stk::tma_store_2d(&tm_y,", "if (p.K < 0) stk::tma_store_2d(&tm_y,")],
    "split, earlier: silu as the identity": (FILE, "earlier/linear_siluq_exact.cu", [
        ("h[j][half] = epi_pair<MODE_SILU>(", "h[j][half] = epi_pair<MODE_BIAS>(")]),
    "split, earlier: no quantize (the bf16 values' high bytes stored)": (
        FILE, "earlier/linear_siluq_exact.cu", [
            ("const uint32_t q0 = (uint32_t)stk::quantize1(f.x, sc[half], rc[half]) & 0xffu;",
             "const uint32_t q0 = (h[j][half] >> 8) & 0xffu;"),
            ("const uint32_t q1 = (uint32_t)stk::quantize1(f.y, sc[half], rc[half]) & 0xffu;",
             "const uint32_t q1 = h[j][half] >> 24;")]),
    "split, earlier: no cluster exchange (each row's amax over the tile's own columns)": (
        FILE, "earlier/linear_siluq_exact.cu", [
            ("            for (int peer = 0; peer < n_tiles; ++peer)\n"
             "              stk::st_async_f32(",
             "            for (int peer = 0; peer < n_tiles && p.K < 0; ++peer)\n"
             "              stk::st_async_f32("),
            ("        stk::mbar_wait_cluster(&xbar[slot], (round >> 1) & 1);\n"
             "        if (tid == 0) stk::mbar_arrive_tx(&xbar[slot], n_tiles * S::ROWS * 4);\n", ""),
            ("          float amax = 0.0f;\n"
             "          for (int peer = 0; peer < n_tiles; ++peer)\n"
             "            amax = fmaxf(amax, xch[(slot * SQ_BLOCKS + peer) * S::ROWS + rr]);\n",
             "          const float amax = am[half];\n")]),
    "split, earlier: no stores (the int8 tiles' TMA stores skipped)": (
        FILE, "earlier/linear_siluq_exact.cu",
        [("stk::tma_store_2d(&tm_y,", "if (p.K < 0) stk::tma_store_2d(&tm_y,")]),
    "split: the table's lookups without bank conflicts (each lane its own words)": [
        ('#include "silu_table.cuh"\n', replaced(
            SILU_TABLE, "  const uint32_t wlo = tab[c2 & 0xffffu], whi = tab[c2 >> 16];",
            "  const uint32_t wlo = tab[(threadIdx.x & 31) + 0 * c2], whi = tab[(threadIdx.x & 31) + 32];"
        ))]}
# the whole-row form with the exponentials of the column groups jj where
# `which` holds by exp2 on the FMA pipe: 2^x = 2^n 2^f, n = rint(x), 2^f by
# its degree-5 Taylor polynomial on |f| <= 1/2 (a few ulp of f32), 0 below
# -126 (as ex2.approx.ftz flushes)
def rows_poly(which: str) -> list:
    return [
        ("constexpr float LOG2E = 1.4426950408889634f;",
         "constexpr float LOG2E = 1.4426950408889634f;\n"
         "__device__ __forceinline__ float exp2_poly(float x) {\n"
         "  const float y = fmaxf(x, -126.0f);\n"
         "  const float r = y + 12582912.0f, f = y - (r - 12582912.0f);\n"
         "  float p = fmaf(1.3333558e-3f, f, 9.6181291e-3f);\n"
         "  p = fmaf(fmaf(fmaf(fmaf(p, f, 5.5504109e-2f), f, 2.4022651e-1f), f, 6.9314718e-1f), f,"
         " 1.0f);\n"
         "  const float e = __int_as_float(__float_as_int(p) + ((__float_as_int(r) - 0x4B400000)"
         " << 23));\n"
         "  return x < -126.0f ? 0.0f : e;\n"
         "}"),
        ("        x = stk::exp2_ftz(x - m[e >> 1]);",
         f"        x = {which} ? exp2_poly(x - m[e >> 1]) : stk::exp2_ftz(x - m[e >> 1]);")]


# the whole-row form (attn_rows) with one part taken out at a time
# (unchecked): the S products (S zero: the logits are the bias), the exponentials
# (ex2 as the identity), the P.V products, the exchange of the partial O's
# (each warpgroup stores its own half of the columns of its own partial), the
# output's stores
ROWS_SPLIT = {
    "split: no S products": [
        ("      stk::Wgmma<KW>::template ss<0>(s, stk::desc_sw128(q_addr + 32 * kk),\n"
         "                                     stk::desc_sw128(k_addr + 32 * kk), kk);\n",
         "      s[kk] = 0.0f;\n"),
        ("    stk::wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < DH / 16; ++kk)\n",
         "#pragma unroll\n    for (int e = 0; e < KW / 2; ++e) s[e] = 0.0f;\n"
         "    stk::wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < DH / 16; ++kk)\n")],
    "split: no exponentials": [
        ("        x = stk::exp2_ftz(x - m[e >> 1]);", "        x = x - m[e >> 1];")],
    "split: no P.V products": [
        ("        stk::Wgmma<DH>::template rs<1>(o, pa[kk], stk::desc_sw128(v_addr + kk * 16 * DH "
         "* 2),\n                                       kk > 0);\n",
         "        o[kk] += __uint_as_float(pa[kk][0]);\n")],
    "split: no exchange of the partial O's": [
        ("    stk::named_bar_sync(ROW_BAR, 256);\n    const float4* own",
         "    const float4* own"),
        ("      const float4 x = own[32 * jj], y = theirs[32 * jj];",
         "      const float4 x = own[32 * jj], y = make_float4(0, 0, 0, 0);")],
    "split: no stores": [
        ("      if (qi < Tq)\n        *reinterpret_cast<uint4*>(ob + (size_t)qi * rs + ch * 8) =",
         "      if (qi < Tq && scale_log2 == 12345.0f)\n"
         "        *reinterpret_cast<uint4*>(ob + (size_t)qi * rs + ch * 8) =")],
}
# the two-pass attention design (csrc/earlier/attention_two_pass.cu) with
# one part taken out at a time (unchecked): pass 1's products and
# exponentials (its K loads kept, the statistics constants); pass 1 whole
# (the ring walks pass 2 alone); pass 2's S products (P from the stale S
# registers); every exponential (ex2 as the identity); the P.V products; the
# output's stores
TWO_PASS = "earlier/attention_two_pass.cu"
ROWS_TILES64 = "variants/attention_rows_tiles64.cu"
ROWS_CHUNKS = "variants/attention_rows_chunks.cu"
# that design's S products, one product group a chunk of 64 keys
ROWS_S_PRODUCTS = ("    static_for<NCH>([&](auto chunk) {\n      constexpr int j = decltype(chunk)::value;\n"
              "      const uint32_t kj")
TWO_PASS_STATS = ("    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};",
                  "    float m[2] = {0.0f, 0.0f}, l[2] = {1.0f, 1.0f};")
TWO_PASS_SPLIT = {
    "split, two-pass: no pass-1 products or exponentials (its K loads kept)": (
        FILE, TWO_PASS, [
            TWO_PASS_STATS,
            ("      issue_s(tile);\n      finish_s(tile);\n      release(tile);\n#pragma unroll\n"
             "      for (int r = 0; r < 2; ++r) {\n",
             "      stk::mbar_wait(&sm.full[tile % NS], (tile / NS) & 1);\n      release(tile);\n"
             "#pragma unroll\n      for (int r = 0; r < 0; ++r) {\n")]),
    "split, two-pass: no pass 1 (nor its K loads)": (FILE, TWO_PASS, [
        TWO_PASS_STATS,
        ("for (int step = 0; step < 2 * n_tiles; ++step) {",
         "for (int step = 0; step < n_tiles; ++step) {"),
        ("      const bool with_v = step >= n_tiles;\n"
         "      const int k0 = (with_v ? step - n_tiles : step) * BKT;",
         "      const bool with_v = true;\n      const int k0 = step * BKT;"),
        ("const int k0 = (step >= n_tiles ? step - n_tiles : step) * BKT;",
         "const int k0 = step * BKT;"),
        ("if (step + 1 < 2 * n_tiles) load_bias(step + 1);",
         "if (step + 1 < n_tiles) load_bias(step + 1);"),
        ("    for (int tile = 0; tile < n_tiles; ++tile) {\n      issue_s(tile);",
         "    for (int tile = 0; tile < 0; ++tile) {\n      issue_s(tile);"),
        ("      const int step = n_tiles + tile;", "      const int step = tile;")]),
    "split, two-pass: no pass-2 S products": (FILE, TWO_PASS, [
        ("      issue_s(step);\n      finish_s(step);\n      fence_p(pa);",
         "      stk::mbar_wait(&sm.full[step % NS], (step / NS) & 1);\n      finish_s(step);\n"
         "      fence_p(pa);")]),
    "split, two-pass: no exponentials": (FILE, TWO_PASS, [
        ("constexpr float LOG2E = 1.4426950408889634f;",
         "constexpr float LOG2E = 1.4426950408889634f;\n"
         "__device__ __forceinline__ float no_exp2(float x) { return x; }"),
        ("stk::exp2_ftz(", "no_exp2(")]),
    "split, two-pass: no P.V products": (FILE, TWO_PASS, [
        ("          stk::Wgmma<DH>::template rs<1>(\n"
         "              o[p], pa[kk], stk::desc_sw128(v_addr + p * BKT * DH * 2 + kk * 16 * DH * 2),\n"
         "              tile > 0 || kk > 0);\n",
         "          o[p][kk] += __uint_as_float(pa[kk][0]);\n")]),
    "split, two-pass: no stores": (FILE, TWO_PASS, [
        ("        if (qi < Tq && (DK % DH == 0 || DH * p + ch * 8 < DK))",
         "        if (qi < Tq && scale_log2 == 12345.0f && (DK % DH == 0 || DH * p + ch * 8 < DK))")]),
}
# The replaced chain design (two m64n64k16 products a k-step, the epilogue
# in f32) and the splits of it and of the committed one: without the
# epilogues (the barrier kept), without the conv-boundary barrier, without
# the weight stages (none loaded nor waited for), the products alone, the
# window's load and store alone, and without the epilogues with two
# consumers at every C (the replaced design)
CHAIN_NO_EPILOGUE = (CHAIN_EPILOGUE, CHAIN_EPILOGUE + "    if (Tlen >= 0) {\n"
                     "      stk::named_bar_sync(1, L::NC * 128);\n      continue;\n    }\n")
CHAIN_BARRIER = ("    // the next conv reads rows the other consumer wrote\n"
                 "    stk::named_bar_sync(1, L::NC * 128);\n")
CHAIN_NO_W = [("      for (int s = 0; s < steps; ++s) {",
               "      for (int s = 0; s < (Tlen < 0 ? steps : 0); ++s) {"),
              ("      stk::mbar_wait(&full[st], (step / NS) & 1);",
               "      if (Tlen < 0) stk::mbar_wait(&full[st], (step / NS) & 1);")]
CHAIN_EARLIER_SPLIT = {
    "split, earlier: no epilogue": [CHAIN_NO_EPILOGUE],
    "split, earlier: no conv-boundary barrier": [
        (CHAIN_BARRIER, "    if (Tlen < 0) stk::named_bar_sync(1, L::NC * 128);\n")],
    "split, earlier: no weight loads or waits (the products on whatever the ring holds)":
        CHAIN_NO_W,
    "split, earlier: the products alone (no epilogue, no weight loads or waits)": [
        CHAIN_NO_EPILOGUE, *CHAIN_NO_W],
    "split, earlier: no epilogue, two consumer warpgroups at every C": [
        CHAIN_NO_EPILOGUE,
        ("constexpr int WIDE_CONSUMERS = 4;", "constexpr int WIDE_CONSUMERS = 2;")],
    "split, earlier: the window's load and store alone": [
        ("  for (int conv = 0; conv < 2 * P; ++conv) {",
         "  for (int conv = 0; conv < (Tlen < 0 ? 2 * P : 0); ++conv) {"), CHAIN_NO_W[0]]}
# the committed chain's epilogue in f32 (the replaced design's arithmetic:
# three scalar roundings a value, the mask and residual in f32)
CHAIN_PACKED_HS = ("              const float2 vf = __bfloat1622float2(v);\n"
                   "              *reinterpret_cast<uint32_t*>(Hs + at) = silu_pair(vf.x, vf.y);\n")
CHAIN_PACKED_X = (
    "              __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(X + at);\n"
    "              const __nv_bfloat162 xn = __hadd2_rn(*xp, v);\n"
    "              *xp = xn;\n"
    "              if (!last) {  // the last conv's silu(x) has no reader\n"
    "                const float2 xf = __bfloat1622float2(xn);\n"
    "                *reinterpret_cast<uint32_t*>(S + at) = silu_pair(xf.x, xf.y);\n"
    "              }\n")
CHAIN_F32_HS = "              *reinterpret_cast<uint32_t*>(Hs + at) = silu_pair(v0, v1);\n"
CHAIN_F32_X = (
    "              uint32_t* xp = reinterpret_cast<uint32_t*>(X + at);\n"
    "              const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));\n"
    "              const float x0 = stk::rnd<bf16>(xf.x + v0), x1 = stk::rnd<bf16>(xf.y + v1);\n"
    "              *xp = stk::pack_bf16(x0, x1);\n"
    "              if (!last)  // the last conv's silu(x) has no reader\n"
    "                *reinterpret_cast<uint32_t*>(S + at) = silu_pair(x0, x1);\n")
CHAIN_F32_EPILOGUE = [
    ("            const __nv_bfloat162 v = __hmul2_rn(\n"
     "                __floats2bfloat162_rn(acc[i][e] + bv.x, acc[i][e + 1] + bv.y), mrow[i][h]);\n",
     "            const float mf = __bfloat162float(mrow[i][h].x);\n"
     "            const float v0 = stk::rnd<bf16>(acc[i][e] + bv.x) * mf;\n"
     "            const float v1 = stk::rnd<bf16>(acc[i][e + 1] + bv.y) * mf;\n"),
    (CHAIN_PACKED_HS, CHAIN_F32_HS), (CHAIN_PACKED_X, CHAIN_F32_X)]
# the design this PR replaced, on today's source: two m64n64k16 products a
# k-step and the epilogue in f32
CHAIN_TWO_PRODUCTS = [("          if constexpr (NPC == 2) {  // both panels in one product",
                       "          if constexpr (NPC == -2) {  // both panels in one product")]
CHAIN_EARLIER = CHAIN_TWO_PRODUCTS + CHAIN_F32_EPILOGUE
# the committed chain without its producer warpgroup: the first thread loads
# the ring under a predicate, every thread running the same instructions
CHAIN_SELF_ISSUE = [
    ("  static constexpr int THREADS = (NC + 1) * 128;",
     "  static constexpr int THREADS = NC * 128;  // no producer warpgroup"),
    ("  if (wg == L::NC) {\n"
     "    // producer: one thread streams stage s = rows [r KC, r KC + KC) of conv\n"
     "    // s / NK's tap-major [k*C, C] weights (convs a, b, a, b, ...), r = s % NK\n"
     "    stk::regs_dealloc<PRODUCER_REGS>();\n"
     "    if (threadIdx.x % 128 == 0) {\n"
     "      for (int s = 0; s < steps; ++s) {\n"
     "        const int st = s % NS, conv = s / NK;\n"
     "        stk::mbar_wait(&empty[st], ((s / NS) & 1) ^ 1);\n"
     "        stk::mbar_arrive_tx(&full[st], L::NP * L::PANEL);\n"
     "        const CUtensorMap* map = (conv & 1) ? &tm_wb : &tm_wa;\n"
     "        const int row = (conv >> 1) * k * C + (s % NK) * KC;\n"
     "#pragma unroll\n"
     "        for (int p = 0; p < L::NP; ++p)\n"
     "          stk::tma_load_2d(ring + st * L::STAGE + p * L::PANEL, map, &full[st], 64 * p, row);\n"
     "      }\n"
     "    }\n"
     "    return;\n"
     "  }\n"
     "\n"
     "  stk::regs_alloc<stk::consumer_regs(L::NC, 1, PRODUCER_REGS)>();\n",
     "  // stage s = rows [r KC, r KC + KC) of conv s / NK's tap-major [k*C, C]\n"
     "  // weights (convs a, b, a, b, ...), r = s % NK, into slot s % NS: issued by\n"
     "  // thread 0 under a predicate, every thread running the same instructions\n"
     "  // (a branch around them would serialise the products, C7518)\n"
     "  const bool issuer = threadIdx.x == 0;\n"
     "  auto issue = [&](int s) {\n"
     "    const int st = s % NS, conv = s / NK;\n"
     "    arrive_tx_if(issuer, &full[st], L::NP * L::PANEL);\n"
     "    const CUtensorMap* map = (conv & 1) ? &tm_wb : &tm_wa;\n"
     "    const int row = (conv >> 1) * k * C + (s % NK) * KC;\n"
     "#pragma unroll\n"
     "    for (int p = 0; p < L::NP; ++p)\n"
     "      tma_load_2d_if(issuer, ring + st * L::STAGE + p * L::PANEL, map, &full[st], 64 * p, row);\n"
     "  };\n"
     "  int issued = NS < steps ? NS : steps;  // stages issued\n"
     "  for (int s = 0; s < issued; ++s) issue(s);\n"),
    ("  auto release = [&](int s) {\n"
     "    __syncwarp();\n"
     "    if (lane == 0) stk::mbar_arrive(&empty[s % NS]);\n"
     "  };",
     "  // the warp's products of stage s are complete: it releases the slot, and\n"
     "  // slots every warp has released take the stages NS on\n"
     "  auto release = [&](int s) {\n"
     "    __syncwarp();\n"
     "    arrive_if(lane == 0, &empty[s % NS]);\n"
     "    for (; issued < steps && issued < s + 1 + NS; ++issued) {\n"
     "      stk::mbar_wait(&empty[issued % NS], ((issued / NS) - 1) & 1);\n"
     "      issue(issued);\n"
     "    }\n"
     "  };"),
    ("  static int regs_at_entry = 0;\n"
     "  if (int err = stk::check_reg_split(kernel, 128, L::NC * 128,\n"
     "                                     stk::consumer_regs(L::NC, 1, PRODUCER_REGS), regs_at_entry,\n"
     "                                     PRODUCER_REGS))\n"
     "    return err;\n",
     ""),
    ("// silu of two values, rounded to bf16 and packed: the fast exponential and",
     "// one arrival, one expecting bytes of TMA traffic, and a 2-d TMA load, each\n"
     "// only where on holds: predicated instructions, no branch\n"
     "__device__ __forceinline__ void arrive_if(bool on, uint64_t* bar) {\n"
     '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.u32 p, %1, 0;\\n"\n'
     '               "@p mbarrier.arrive.shared::cta.b64 _, [%0];\\n}\\n" ::"r"(stk::smem_u32(bar)),\n'
     '               "r"((uint32_t)on)\n'
     '               : "memory");\n'
     "}\n"
     "__device__ __forceinline__ void arrive_tx_if(bool on, uint64_t* bar, uint32_t bytes) {\n"
     '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.u32 p, %2, 0;\\n"\n'
     '               "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n}\\n" ::"r"(\n'
     "                   stk::smem_u32(bar)),\n"
     '               "r"(bytes), "r"((uint32_t)on)\n'
     '               : "memory");\n'
     "}\n"
     "__device__ __forceinline__ void tma_load_2d_if(bool on, void* dst, const CUtensorMap* map,\n"
     "                                               uint64_t* bar, int c0, int c1) {\n"
     '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.u32 p, %5, 0;\\n"\n'
     '               "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
     '               "[%0], [%1, {%3, %4}], [%2];\\n}\\n" ::"r"(stk::smem_u32(dst)),\n'
     '               "l"(reinterpret_cast<uint64_t>(map)), "r"(stk::smem_u32(bar)), "r"(c0), "r"(c1),\n'
     '               "r"((uint32_t)on)\n'
     '               : "memory");\n'
     "}\n"
     "\n"
     "// silu of two values, rounded to bf16 and packed: the fast exponential and"),
]
CHAIN_NO_PRODUCTS = [
    ("stk::Wgmma<64>::template rs<1>(", "if (Tlen < 0) stk::Wgmma<64>::template rs<1>("),
    ("stk::Wgmma<128>::template rs<1>(", "if (Tlen < 0) stk::Wgmma<128>::template rs<1>(")]
SPLIT = {"resblock_chain": {
    "split: silu as the identity": [
        ("  return stk::pack_bf16(stk::silu_fast(a), stk::silu_fast(b));",
         "  return stk::pack_bf16(a, b);")],
    "split: no epilogue": [CHAIN_NO_EPILOGUE],
    "split: no products": CHAIN_NO_PRODUCTS,
    "split: no conv-boundary barrier": [
        (CHAIN_BARRIER, "    if (Tlen < 0) stk::named_bar_sync(1, L::NC * 128);\n")],
    "split: no weight loads or waits (the products on whatever the ring holds)": CHAIN_NO_W,
    "split: the products alone (no epilogue, no weight loads or waits)": [
        CHAIN_NO_EPILOGUE, *CHAIN_NO_W],
    "split: the window's load and store alone": [
        ("  for (int conv = 0; conv < 2 * P; ++conv) {",
         "  for (int conv = 0; conv < (Tlen < 0 ? 2 * P : 0); ++conv) {"), CHAIN_NO_W[0]],
    **{name: CHAIN_EARLIER + subs for name, subs in CHAIN_EARLIER_SPLIT.items()}},
    "quantize": {
        "split: loads only": [
            ("  stk::mbar_wait(&full[warp], 0);\n", "  stk::mbar_wait(&full[warp], 0);\n"
             "  if (K >= 0) return;\n")],
        "split: loads and the row max (no division, no xq)": [
            ("  if (sub == 0) *sx_row = sc;\n", "  if (sub == 0) *sx_row = sc;\n  if (K >= 0) return;\n")],
        "split: a product with 1 / sx for the division (not bit-equal)": [
            ('#include "quantize8.cuh"\n', QUANTIZE8.replace("__float2int_rn(__fdiv_rn(v, s))",
                                                             "__float2int_rn(v * s)"))],
        "split, earlier: loads and the row max (no division, no xq)": (
            FILE, "earlier/quantize_warp_rows.cu",
            [("*reinterpret_cast<uint2*>(qr + c * 8) = quantize8(v, s);", "")])},
    "conv1d": {
        "split: no products": [
            ("stk::Wgmma<BN>::template ss<1>(", "if (p.Tlen < 0) stk::Wgmma<BN>::template ss<1>(")],
        "split: no silu in the staging": [("        if (p.silu_in) {\n          const int rows",
                                           "        if (p.silu_in && p.Tlen < 0) {\n"
                                           "          const int rows")],
        "split: no epilogue": [
            ("    // the epilogue from the registers, a row",
             "    if (p.Tlen > 0) continue;\n    // the epilogue from the registers, a row")],
        "split: the epilogue without its residual loads": [
            ("          if (residual && n < p.Cout) {",
             "          if (residual && n < p.Cout && p.Tlen < 0) {")],
        "split: the epilogue without its stores": [
            ("              *reinterpret_cast<uint32_t*>(o) = pair;",
             "              if (p.Tlen < 0) *reinterpret_cast<uint32_t*>(o) = pair;"),
            ("              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);",
             "              if (p.Tlen < 0) *reinterpret_cast<float2*>(o) =\n"
             "                  make_float2(v0, v1);")]},
    "linear": {
        "split: the rope form without its rotation (its bias forms stored)": [
            ("                  uint32_t o1, o2;\n"
             "                  rotate(bf[r][half][j], bf[r][half][jp], cvs[q], svs[q], o1, o2);",
             "                  uint32_t o1 = bf[r][half][j], o2 = bf[r][half][jp];\n"
             "                  if (p.K < 0)\n"
             "                    rotate(bf[r][half][j], bf[r][half][jp], cvs[q], svs[q], o1, o2);"),
            ("                  uint32_t o1, o2;\n                  rotate(a, b, cv, sv, o1, o2);",
             "                  uint32_t o1 = a, o2 = b;\n"
             "                  if (p.K < 0) rotate(a, b, cv, sv, o1, o2);")],
        "split: the rope form without its cos and sin loads": ROPE_NO_ANGLES,
        "split: the residual form without its residual loads (nor the tail's x_in)":
            RESID_NO_RES_LOADS,
        "split: the residual form without its gate loads": RESID_NO_GATE,
        "split: the residual form without W's loads after a block's first tile": RESID_NO_W,
        "split: the residual form without X's loads after a block's first tile": RESID_NO_X,
        "split: the residual form as the product alone on its tiles (its bias form; no "
        "residual or gate loads)": RESID_PRODUCT_ALONE,
        "split: the residual form as the product alone on 128 x 128 tiles of two consumers, "
        "4 ring stages": [*RESID_PRODUCT_ALONE, RESID_ON_MANY],
        "split: no epilogue math (the sums stored as they are)": LINEAR_NO_MATH,
        "split: no products": LINEAR_NO_PRODUCTS,
        "split: no stores (the results' TMA stores, or register stores, skipped)":
            LINEAR_NO_STORES,
        "split: loads only (no products, no epilogue math, no stores)": (
            LINEAR_NO_MATH + LINEAR_NO_PRODUCTS + LINEAR_NO_STORES)},
    "silu_quantize": SILUQ_SPLIT,
    "attention": {**ROWS_SPLIT, **TWO_PASS_SPLIT},
    "w8a8_forms": {
        "split: the rope form without its rotation (its bias forms stored)": None,
        "split: the rope form without its cos and sin loads": None,
        "split: the residual form without its residual loads (nor the tail's x_in)": None,
        "split: the residual form without its gate loads": None,
        "split: the residual form without W's loads after a block's first tile": None,
        "split: the residual form without X's loads after a block's first tile": None,
        "split: the residual form as the product alone on its tiles (its bias form; no "
        "residual or gate loads)": None,
        "split: the residual form as the product alone on 128 x 128 tiles of two consumers, "
        "4 ring stages": None,
        "split: no epilogue math (the sums stored as they are)": None,
        "split: no products": None,
        "split: no stores (the results' TMA stores, or register stores, skipped)": None},
    "ln_modulate": {
        "split: loads only": [
            ("    if (lane == 0 && i + STAGES < n_rows) issue(i + STAGES);\n",
             "    if (lane == 0 && i + STAGES < n_rows) issue(i + STAGES);\n"
             "    if (D > 0) {\n      if (s == 12345.0f) out[0] = in[0];\n      continue;\n    }\n")],
        "split, earlier: loads only": (
            FILE, "earlier/ln_modulate_warp_rows.cu",
            [("    const float mean = __fdiv_rn(stk::warp_sum(s), (float)D);\n    float q = 0.0f;\n"
              "#pragma unroll\n",
              "    if (D > 0) {\n      if (s == 12345.0f) out[0] = xr[0];\n      continue;\n    }\n"
              "    const float mean = __fdiv_rn(stk::warp_sum(s), (float)D);\n    float q = 0.0f;\n"
              "#pragma unroll\n")])}}
UP = "using UpTile = stk::WgTile<2, 2, 128, 4, 1, true>;"
DOWN = "using DownTile = stk::WgTile<2, 2, 128, 4, 1, true>;"
UP_FEW = "using UpTileSmall = stk::WgTile<2, 1, 64, 8, 1, true>;"
DOWN_FEW = "using DownTileSmall = stk::WgTile<2, 1, 32, 8, 1, true, false, false>;"
I8_BIG = "using Bf16Tile = stk::WgTile<2, 2, 128, 4, 1, true>;"
I8_FEW = "using Bf16TileFew = stk::WgTile<2, 1, 64, 8, 1, true>;"
I8_WIDE = "using WideTile = stk::WgTile<2, 1, 128, 4, 1, true, false, true, 4>;"
I8_WIDE_FEW = "using WideTileFew = stk::WgTile<2, 1, 64, 8, 1, true, false, true, 4>;"


def tile(line: str, args: str) -> tuple[str, str]:
    """(committed tile line, the same line with other WgTile arguments)."""
    return line, line[:line.index("<") + 1] + args + ">;"


VARIANTS = {  # kernel: {variant: [(committed text, variant text), ...] or (FILE, path, [...])}
    "attention": {
        "earlier: the two-pass design": (FILE, TWO_PASS, []),
        "first build: key tiles of 64, S a product a tile, Tk padded to 128": (
            FILE, ROWS_TILES64, []),
        "the next tile's S products while a tile's output is finished": (
            FILE, "variants/attention_rows_s_overlap.cu", []),
        "S a product group a chunk of 64 keys (a chunk's max while the next run)": (
            FILE, ROWS_CHUNKS, []),
        "a third of the exponentials by a polynomial on the FMA pipe": rows_poly("jj % 3 == 2"),
        "a quarter of the exponentials by a polynomial on the FMA pipe": rows_poly("jj % 4 == 3"),
        "S by chunks, K and V waited for chunk by chunk at every tile": (FILE, ROWS_CHUNKS, [
            (ROWS_S_PRODUCTS, ROWS_S_PRODUCTS.replace(
                "      const uint32_t kj",
                "      stk::mbar_wait(&sm.k_full[box(j, 0)], 0);\n"
                "      stk::mbar_wait(&sm.k_full[box(j, (j < NCH - 1 ? 64 : LAST) - 1)], 0);\n"
                "      const uint32_t kj")),
            ("      stk::wgmma_fence();\n#pragma unroll\n      for (int kk = 4 * j; kk < k_end; ++kk)\n",
             "      stk::mbar_wait(&sm.v_full[box(j, 0)], 0);\n"
             "      stk::mbar_wait(&sm.v_full[box(j, (j < NCH - 1 ? 64 : LAST) - 1)], 0);\n"
             "      stk::wgmma_fence();\n#pragma unroll\n      for (int kk = 4 * j; kk < k_end; ++kk)\n")]),
        "one query tile a block (K and V loaded for each)": [
            ("  int G = per_block < 1 ? 1 : per_block > nq ? nq : (int)per_block;",
             "  int G = 1;")],
        "earlier: mma.sync, cp.async ring": (FILE, "earlier/attention_mma_sync.cu", [])},
    "attention_f32": {
        "earlier: instances at Dh 32-128": (FILE, "earlier/attention_f32_simt.cu", [])},
    "resblock_chain": {
        "earlier: two m64n64k16 products a k-step, the epilogue in f32": CHAIN_EARLIER,
        "earlier: mma.sync, cp.async ring": (FILE, "earlier/resblock_chain_mma_sync.cu", []),
        "the epilogue in f32 (three roundings a value, the mask and residual in f32)":
            CHAIN_F32_EPILOGUE,
        "two m64n64k16 products a k-step (no m64n128k16)": CHAIN_TWO_PRODUCTS,
        "no producer warpgroup (the first thread loads the ring under a predicate)":
            CHAIN_SELF_ISSUE,
        "accurate silu": CHAIN_ACC,
        "half the exponentials by a polynomial on the FMA pipe": CHAIN_POLY,
        "clusters of 2, weight stages multicast (on the replaced design)": (FILE, CLUSTER_SRC, []),
        "clusters of 4, weight stages multicast (on the replaced design)": (
            FILE, CLUSTER_SRC, [("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 4;")]),
        "two consumer warpgroups at every C": [
            ("constexpr int WIDE_CONSUMERS = 4;", "constexpr int WIDE_CONSUMERS = 2;")],
        "the conv size at run time only (no k = 3 instances)": [
            ("  const int k = KT ? KT : k_;", "  const int k = k_;")],
        "largest tile at every shape": [
            ("W0 / 2 > 2 * t.halo && B > 0", "W0 / 2 > 2 * t.halo && B < 0")],
        "no 64-channel stages (32, 16 at C 256)": [
            ("BUFS <= 128 * 1024 && (C / 64)", "BUFS < 1 && (C / 64)")]},
    "ffn": {
        "earlier: mma.sync, cp.async ring": (FILE, "earlier/ffn_mma_sync.cu", []),
        "not persistent: one tile a consumer": [
            tile(UP, "2, 2, 128, 4, 1, false"), tile(DOWN, "2, 2, 128, 4, 1, false"),
            tile(UP_FEW, "2, 1, 64, 8, 1, false"),
            tile(DOWN_FEW, "2, 1, 32, 8, 1, false, false, false")],
        "silu by __fdividef (stk::silu_fast)": [
            ("silu_epi(v0 + bv.x), silu_epi(v1 + bv.y)",
             "stk::silu_fast(v0 + bv.x), stk::silu_fast(v1 + bv.y)")],
        "silu's reciprocal by Newton's method on the FMA pipe": [
            ("  float r;\n  asm(\"rcp.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(r) : \"f\"(y));\n",
             "  float r = __int_as_float(0x7EF311C7 - __float_as_int(fminf(y, 1e30f)));\n"
             "#pragma unroll\n  for (int i = 0; i < 3; ++i) r = r * fmaf(-y, r, 2.0f);\n")],
        "stores from the registers, not by TMA": [
            tile(UP, "2, 2, 128, 4, 1, true, false, false"),
            tile(DOWN, "2, 2, 128, 4, 1, true, false, false"),
            tile(UP_FEW, "2, 1, 64, 8, 1, true, false, false")],
        "GEMM1 in 64 x 256 tiles a consumer": [tile(UP, "2, 1, 256, 4, 1, true")],
        "3 stages": [tile(UP, "2, 2, 128, 3, 1, true"), tile(DOWN, "2, 2, 128, 3, 1, true")],
        "both GEMMs in 128 x 256 tiles shared by both consumers": [
            tile(UP, "2, 1, 256, 3, 1, true, true"), tile(DOWN, "2, 1, 256, 3, 1, true, true")],
        "few rows: GEMM2 in 64 x 64 tiles": [tile(DOWN_FEW, "2, 1, 64, 8, 1, true")]},
    "int8": {
        "earlier: mma.sync, cp.async ring": (FILE, "earlier/int8_matmul_mma_sync.cu", []),
        "the silu form by the exact sequence a value (no silu table)": SILU_EXACT,
        "bf16 results in 64 x 256 tiles a consumer": [tile(I8_BIG, "2, 1, 256, 4, 1, true")],
        "the silu instance in 128 x 128 tiles, two consumer warpgroups": [
            ("using Bf16SiluTile = stk::WgTile<4, 1, 64, 8, 1, true>;",
             "using Bf16SiluTile = stk::WgTile<2, 2, 128, 4, 1, true>;")],
        "the silu instance in 64 x 128 tiles, three consumer warpgroups": [
            ("using Bf16SiluTile = stk::WgTile<4, 1, 64, 8, 1, true>;",
             "using Bf16SiluTile = stk::WgTile<3, 1, 128, 4, 1, true>;")],
        "3 stages": [tile(I8_BIG, "2, 2, 128, 3, 1, true"),
                     tile(I8_WIDE, "2, 1, 128, 3, 1, true, false, true, 4")],
        "not persistent: one tile a consumer": [
            tile(I8_BIG, "2, 2, 128, 4, 1, false"), tile(I8_FEW, "2, 1, 64, 8, 1, false"),
            tile(I8_WIDE, "2, 1, 128, 4, 1, false, false, true, 4"),
            tile(I8_WIDE_FEW, "2, 1, 64, 8, 1, false, false, true, 4")],
        "stores from the registers, not by TMA": [
            tile(I8_BIG, "2, 2, 128, 4, 1, true, false, false"),
            tile(I8_FEW, "2, 1, 64, 8, 1, true, false, false"),
            tile(I8_WIDE, "2, 1, 128, 4, 1, true, false, false, 4"),
            tile(I8_WIDE_FEW, "2, 1, 64, 8, 1, true, false, false, 4")],
        "128 x 256 tiles shared by both consumers": [
            tile(I8_BIG, "2, 1, 256, 3, 1, true, true")]},
    "quantize": {
        "earlier: one warp a row": (FILE, "earlier/quantize_warp_rows.cu", []),
        "persistent blocks, each warp a ring of 1-4 KB stages": (
            FILE, "variants/quantize_persistent_ring.cu", []),
        "4 KB of rows a warp (4 rows at K 512)": [
            ("constexpr int STAGED = 2048;", "constexpr int STAGED = 4096;")],
        "1 KB of rows a warp (1 row at K 512)": [
            ("constexpr int STAGED = 2048;", "constexpr int STAGED = 1024;")],
        "8 warps a block": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")]},
    "ln_quantize": {
        "each quotient by __fdiv_rn (no row reciprocal)": [
            ("stk::quantize8(f, sc, rc)", "stk::quantize8(f, sc)")]},
    "silu_quantize": {
        "earlier: the replaced design (64 x 256 tiles, clusters of 8, two consumers, the "
        "exact sequence a value)": (FILE, "earlier/linear_siluq_exact.cu", []),
        "the exact sequence a value (no silu table)": SILU_EXACT,
        "each quotient by __fdiv_rn (no row reciprocal)": [
            ("stk::quantize1(f.x, sc[half], rc[half])", "stk::quantize1(f.x, sc[half])"),
            ("stk::quantize1(f.y, sc[half], rc[half])", "stk::quantize1(f.y, sc[half])")],
        "four consumers (96 registers a thread)": [
            (LIN_SILUQ, "using SiluQ = Tile<4, 1, 128, 8, 1, false, true, 1, 4>;")],
        "two consumers": [(LIN_SILUQ, "using SiluQ = Tile<2, 1, 128, 8, 1, false, true, 1, 4>;")],
        "64 x 256 tiles in clusters of 8 blocks (the portable size), two consumers, 5 ring "
        "stages": [("constexpr int SQ_BLOCKS = 16;", "constexpr int SQ_BLOCKS = 8;"),
                   (LIN_SILUQ, "using SiluQ = Tile<2, 1, 256, 5, 1, false, true, 1, 4>;")],
        "64 x 256 tiles in clusters of 8 blocks, two consumers, the exact sequence a value": [
            ("constexpr int SQ_BLOCKS = 16;", "constexpr int SQ_BLOCKS = 8;"),
            (LIN_SILUQ, "using SiluQ = Tile<2, 1, 256, 5, 1, false, true, 1, 4>;"),
            *SILU_EXACT]},
    "ln_modulate": {
        "earlier: one warp a row": (FILE, "earlier/ln_modulate_warp_rows.cu", []),
        "2 row slots a warp": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
        "4 row slots a warp": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]},
    "conv1d": {
        "earlier: one tile a block, not persistent": (
            FILE, "earlier/conv1d_tile_per_block.cu", []),
        "earlier with A in registers by ldmatrix from swizzled windows, 128 x 128 tiles": (
            FILE, "variants/conv1d_register_a.cu", []),
        "every tile stages its own windows (silu once a column tile)": [
            ("  p.L = p.nunits <= p.NWB ? p.NT : 1;", "  p.L = 1;")],
        "3 ring stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
        "the epilogue's options read at run time (one instance for every call)": [
            ("  const bool compiled = Cout % 2 == 0 && (!mask || fold == 1 || (Cout / fold) % bn == 0);",
             "  const bool compiled = false;")],
        "the masked convs' consumers in turns wherever (not cooperative where windows stay)": [
            ("return coop_stays ? STK_CONV(128, 3, E_MASK, true)",
             "return false ? STK_CONV(128, 3, E_MASK, true)")],
        "the masked convs' consumers on shared 256-row tiles wherever (cooperative)": [
            ("return coop_stays ? STK_CONV(128, 3, E_MASK, true)",
             "return true ? STK_CONV(128, 3, E_MASK, true)")],
        "the pre_res instances' consumers on shared 256-row tiles (cooperative)": [
            ("STK_CONV(128, 3, E_SILU | E_MASK, false)", "STK_CONV(128, 3, E_SILU | E_MASK, true)"),
            ("STK_CONV(128, 3, E_MASK | E_RES, false)", "STK_CONV(128, 3, E_MASK | E_RES, true)")],
        "the prenet's consumers in turns (not cooperative)": [
            ("E_SILU | E_MASK | E_RES, true)", "E_SILU | E_MASK | E_RES, false)")],
        "the head's consumers in turns (not cooperative)": [
            ("STK_CONV(64, 7, E_TANH, true)", "STK_CONV(64, 7, E_TANH, false)"),
            ("STK_CONV(64, 7, E_TANH | E_I16, true)", "STK_CONV(64, 7, E_TANH | E_I16, false)")],
        "the head with 11 staging warps": [
            ("STK_CONV(64, 7, E_TANH, true)", "STK_CONV(64, 11, E_TANH, true)"),
            ("STK_CONV(64, 7, E_TANH | E_I16, true)", "STK_CONV(64, 11, E_TANH | E_I16, true)")]},
    # the W8A8 product's rope and residual forms (csrc/linear.cu's GEMM with
    # its s8 operand; the residual tiles are the bf16 residual form's too)
    "w8a8_forms": {
        "earlier: the rope form's cos and sin from device memory in the epilogue (the replaced "
        "design)": (FILE, ROPE_EARLIER, []),
        "earlier: the residual form's replaced design (f32 epilogue arithmetic, 64 x 128 tiles "
        "of three consumers everywhere)": (FILE, RESID_EARLIER, []),
        "the rope form at a streamed chunk's M on 64 x 128 tiles of one consumer, the angles "
        "by TMA": ROPE_FEW_WIDE,
        "the rope form on 64 x 128 tiles, three consumers, 7 ring stages (the replaced design's "
        "tiles), the angles by TMA": [
            (LIN_ROPE8, "using RopeMany8 = Tile<3, 1, 128, 7, 1, false, true, 2>;")],
        "the rope form on 64 x 128 tiles, two consumers, 6 ring stages": [
            (LIN_ROPE8, "using RopeMany8 = Tile<2, 1, 128, 6, 1, false, true, 2>;")],
        "the rope form on 128 x 128 tiles with 5 ring stages, the weight scales from "
        "device memory": [(LIN_ROPE8, "using RopeMany8 = Tile<2, 2, 128, 5, 1, false, true, 2>;"),
                          *W8A8_WS_GLOBAL],
        "the replaced residual form on 128 x 128 tiles, two consumers, 4 ring stages": (
            FILE, RESID_EARLIER,
            [(LIN_RESID, "using ManyResid = Tile<2, 2, 128, 4, 1, false, true, 2>;")]),
        "the replaced residual form on 64 x 128 tiles, four consumers, 5 ring stages": (
            FILE, RESID_EARLIER,
            [(LIN_RESID, "using ManyResid = Tile<4, 1, 128, 5, 1, false, true, 2>;")]),
        **RESID_VARIANTS},
    "linear": {
        **{f"the bias form on {tiles} at every shape": [
            (LIN_PICK_BIAS, LIN_PICK_BIAS + f"  if (mode == MODE_BIAS) return {instance};\n"),
            LIN_BIAS_DISPATCH] for tiles, instance in BIAS_INSTANCES},
        **{f"the bias form on {tiles} where it takes 128 x 128 tiles": [
            (LIN_MANY, f"using Many = Tile<{args}>;")] for tiles, args in BIAS_MANY_TILES},
        "the bias form's 64 x 64 tiles with 8 ring stages, one block an SM": [
            (LIN_FEW, "using Few = Tile<1, 1, 64, 8, 1, false, true, 2>;")],
        "earlier: the replaced design, on the FFN's GEMM template": (
            FILE, "earlier/linear_pr17.cu", []),
        "silu by a fast quotient, guarded, the refused pairs in a second pass": (
            FILE, "variants/linear_fast_silu.cu", []),
        "128 x 128 tiles with 4 ring stages": [
            (LIN_MANY, "using Many = Tile<2, 2, 128, 4, 1, false, true, 2>;")],
        "128 x 128 tiles stored from the registers, 6 ring stages": [
            (LIN_MANY, "using Many = Tile<2, 2, 128, 6, 1, false, false, 2>;")],
        "the bias form in 128 x 256 tiles shared by both consumers": [
            (LIN_MANY, "using Many = Tile<2, 1, 256, 3, 1, true, true, 2>;")],
        "the silu form in 64 x 64 tiles, four consumer warpgroups": [
            (LIN_MANY_SILU, "using ManySilu = Tile<4, 1, 64, 8, 1, false, true, 2>;")],
        "the silu form in 128 x 128 tiles, two consumer warpgroups": [
            (LIN_MANY_SILU, "using ManySilu = Tile<2, 2, 128, 5, 1, false, true, 2>;")],
        "the silu form in 64 x 128 tiles, three consumer warpgroups": [
            (LIN_MANY_SILU, "using ManySilu = Tile<3, 1, 128, 6, 1, false, true, 2>;")],
        "the silu form in 128 x 64 tiles, four consumer warpgroups": [
            (LIN_MANY_SILU, "using ManySilu = Tile<4, 2, 64, 6, 1, false, true, 2>;")],
        "the silu form in 64 x 256 tiles, two consumer warpgroups": [
            (LIN_MANY_SILU, "using ManySilu = Tile<2, 1, 256, 3, 1, false, true, 2>;")],
        "the silu form in 128 x 256 tiles shared by both consumers": [
            (LIN_MANY_SILU, "using ManySilu = Tile<2, 1, 256, 3, 1, true, true, 2>;")],
        "the bias form in 64 x 128 tiles, four consumer warpgroups": [
            (LIN_MANY, "using Many = Tile<4, 1, 128, 5, 1, false, true, 2>;")],
        "the tail's x_in read from device memory, results from the registers": [
            (LIN_TAIL, "using TailTile = Tile<2, 1, 96, 6, 1, false, false, 4>;")],
        "the tail in 64 x 128 tiles (32 zero columns at N 96)": [
            (LIN_TAIL, "using TailTile = Tile<2, 1, 128, 4, 1, false, true, 4>;")],
        "earlier: the rope form's cos and sin from device memory in the epilogue (the replaced "
        "design)": (FILE, ROPE_EARLIER, []),
        "earlier: the residual form's replaced design (f32 epilogue arithmetic, 64 x 128 tiles "
        "of three consumers everywhere)": (FILE, RESID_EARLIER, []),
        "the rope form at a streamed chunk's M on 64 x 128 tiles of one consumer, the angles "
        "by TMA": ROPE_FEW_WIDE,
        "the replaced rope form (the angles from device memory) on 64 x 128 tiles of three "
        "consumer warpgroups, 7 ring stages": (
            FILE, ROPE_EARLIER,
            [(LIN_ROPE, "using RopeMany = Tile<3, 1, 128, 7, 1, false, true, 2>;")]),
        "the rope form on 64 x 128 tiles of three consumer warpgroups, 7 ring stages, the "
        "angles by TMA": [(LIN_ROPE, "using RopeMany = Tile<3, 1, 128, 7, 1, false, true, 2>;")],
        "the rope form at Dh 64 in 64 x 256 tiles (four heads a tile)": [
            (LIN_ROPE, "using RopeMany = Tile<2, 1, 256, 3, 1, false, true, 2>;")],
        "the rope form in 64 x 128 tiles, four consumer warpgroups": [
            (LIN_ROPE, "using RopeMany = Tile<4, 1, 128, 5, 1, false, true, 2>;")],
        "the rope form's cos and sin staged in shared memory, 128 x 128 tiles, 3 ring stages": (
            FILE, ROPE_STAGED_SRC,
            [(LIN_ROPE, "using RopeMany = Tile<2, 2, 128, 3, 1, false, true, 2>;")]),
        "the rope form's cos and sin staged in shared memory, 64 x 256 tiles, 3 ring stages": (
            FILE, ROPE_STAGED_SRC,
            [(LIN_ROPE, "using RopeMany = Tile<2, 1, 256, 3, 1, false, true, 2>;")]),
        "the rope form's cos and sin staged in shared memory, 64 x 128 tiles of four consumer "
        "warpgroups, 3 ring stages": (
            FILE, ROPE_STAGED_SRC,
            [(LIN_ROPE, "using RopeMany = Tile<4, 1, 128, 3, 1, false, true, 2>;")]),
        "the rope form's cos and sin staged in shared memory, 64 x 128 tiles of three consumer "
        "warpgroups, 5 ring stages": (
            FILE, ROPE_STAGED_SRC,
            [(LIN_ROPE, "using RopeMany = Tile<3, 1, 128, 5, 1, false, true, 2>;")]),
        "the replaced residual form in 128 x 128 tiles, two consumer warpgroups, 4 ring stages": (
            FILE, RESID_EARLIER,
            [(LIN_RESID, "using ManyResid = Tile<2, 2, 128, 4, 1, false, true, 2>;")]),
        "the replaced residual form in 64 x 128 tiles, four consumer warpgroups, 6 ring stages": (
            FILE, RESID_EARLIER,
            [(LIN_RESID, "using ManyResid = Tile<4, 1, 128, 6, 1, false, true, 2>;")]),
        "the replaced residual form in 64 x 128 tiles, three consumer warpgroups, 6 ring stages": (
            FILE, RESID_EARLIER,
            [(LIN_RESID, "using ManyResid = Tile<3, 1, 128, 6, 1, false, true, 2>;")]),
        "the residual form's gate from device memory (no rows staged)": [
            (LIN_GATE_STAGED, "              gsel[r][half] = 2;")],
        "the residual form on the bias form's 64 x 32 tiles from the registers where the card "
        "takes few 64 x 64 ones": [
            ("  if (mode == MODE_RESID || 2 * tiles_of<Few>(M, N) >= sms) return I_FEW;",
             "  if (2 * tiles_of<Few>(M, N) >= sms) return I_FEW;")],
        "the replaced residual form stored from the registers (the residual from device memory)": (
            FILE, RESID_EARLIER,
            [(LIN_RESID, "using ManyResid = Tile<2, 2, 128, 6, 1, false, false, 2>;")]),
        **RESID_VARIANTS},
}
ENTRY = {"attention": ("stk_attention", attention._ARGTYPES),
         "attention_f32": ("stk_attention", attention._ARGTYPES),
         "resblock_chain": ("stk_resblock_chain", vocoder_fused._ARGTYPES),
         "ffn": ("stk_adaln_ffn", ffn._ARGTYPES),
         "int8": ("stk_w8a8_matmul", w8a8._ARGTYPES),
         "quantize": ("stk_quantize_rows", quantize._ARGTYPES),
         "ln_modulate": ("stk_ln_modulate", ln_modulate._ARGTYPES),
         "ln_quantize": ("stk_ln_modulate_quantize", ln_modulate._Q_ARGTYPES),
         "silu_quantize": ("stk_w8a8_silu_quantize", w8a8._SQ_ARGTYPES),
         "conv1d": ("stk_conv1d", conv1d._ARGTYPES),
         "linear": ("stk_linear", linear._ARGTYPES),
         "w8a8_forms": ("stk_w8a8_epilogue", w8a8._EPI_ARGTYPES)}
# further entries of a variant's library, {kernel: {name: argtypes}} (a
# variant from another file may lack them)
MORE_ENTRIES = {"int8": {"stk_int8_matmul": int8_matmul._ARGTYPES},
                "linear": {"stk_linear_epilogue": linear._EPI_ARGTYPES},
                "silu_quantize": {"stk_linear": linear._ARGTYPES}}
# names (in ptxas's mangled names) of the device functions whose registers and
# spills each build prints (the bf16 kernels; attention_f32: the f32 ones)
BF16_FUNCTIONS = {"attention": ("attn_rows", "attn_wgmma", "attn_mma"),
                  "attention_f32": ("attn_wide", "attn_kernel"),
                  "resblock_chain": ("chain_mma", "chain_wgmma"),
                  "ffn": ("wgmma_gemm", "mma_gemm", "ln_mod"),
                  "int8": ("wgmma_gemm", "mma_gemm"),
                  "quantize": ("quantize_",), "ln_modulate": ("layer_norm_rows",),
                  "ln_quantize": ("layer_norm_rows",), "silu_quantize": ("w8a8_wgmmaILi5E",),
                  "conv1d": ("conv_wgmma",), "linear": ("linear_wgmma", "linear_simt"),
                  "w8a8_forms": ("w8a8_wgmma", "w8a8_simt")}
# kernels timed from another kernel's source
SOURCE = {"attention_f32": "attention", "int8": "int8_matmul", "w8a8_forms": "linear",
          "ln_quantize": "ln_modulate", "silu_quantize": "linear"}
OUT = _build.BUILD_ROOT / "variants"


def variants_of(kernel: str, split: bool = False) -> dict:
    """VARIANTS[kernel], with ``split`` also its SPLIT entries (None: the
    linear kernel's split of that name)."""
    extra = SPLIT.get(kernel, {}) if split else {}
    return {**VARIANTS[kernel],
            **{name: subs or SPLIT["linear"][name] for name, subs in extra.items()}}


def variant_source(kernel: str, subs) -> str:
    """The source a variant of kernel builds from: the kernel's source with
    subs applied to its bf16 section (the whole source where it has none),
    or (FILE, path, subs) a file under csrc/ with subs applied; raises where
    a substitution's text is not there."""
    if subs and subs[0] == FILE:
        _, where, subs = subs
        src, prefix = (_build.CSRC_DIR / where).read_text(), ""
    else:
        source = (_build.CSRC_DIR / f"{SOURCE.get(kernel, kernel)}.cu").read_text()
        head, src = (source.split(BF16_SECTION) if BF16_SECTION in source
                     else ("", source))
        where, prefix = "the bf16 section", head + BF16_SECTION if head else ""
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{kernel}: '{old}' not in {where}")
        src = src.replace(old, new)
    return prefix + src


def build_variants(kernels) -> dict:
    """{(kernel, variant): C entry of the variant's library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        # the committed source too, for its ptxas report beside the variants'
        for i, (name, subs) in enumerate([("committed", [])] + list(VARIANTS[kernel].items())):
            text = variant_source(kernel, subs)
            path = OUT / f"{kernel}_v{i}.cu"
            path.write_text(text)
            lib = path.with_suffix(".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(_build.CSRC_DIR), "-o", str(lib), str(path)]
            procs[(kernel, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True),
                                     lib)
    fns = {}
    for (kernel, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} / {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):  # the bf16 kernels' registers and spills
            if "Function properties" in line and any(f in line for f in BF16_FUNCTIONS[kernel]):
                cs.log(f"  {kernel} / {name}: {' '.join(x.strip() for x in lines[i + 1:i + 3])}")
            # wgmma serialised by the compiler, or setmaxnreg ignored
            if any(code in line for code in ("C7515", "C7508", "C7510", "C7512", "C7520")):
                cs.log(f"  {kernel} / {name}: {line.strip()[:160]}")
        library = ctypes.CDLL(str(lib))
        entry, argtypes = ENTRY[kernel]
        fns[(kernel, name)] = fn = getattr(library, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        for entry, argtypes in MORE_ENTRIES.get(kernel, {}).items():
            if not hasattr(library, entry):
                continue
            fns[(kernel, name, entry)] = fn = getattr(library, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fns


def attention_call(fn, q, k, v, mask):
    out = torch.empty_like(q)
    b, tq, h, d = q.shape
    P = _build.ptr
    _build.check(fn(P(q), P(k), P(v), P(mask), P(out), b, tq, k.shape[1], h, d,
                    _build.dtype_code(q.dtype), _build.stream_ptr(q), d ** -0.5), "variant")
    return out


def chain_call(fn, x, fm, wa, ba, wb, bb, dils):
    out = torch.empty_like(x)
    b, t_len, c = x.shape
    d = (ctypes.c_int * len(dils))(*dils)
    P = _build.ptr
    _build.check(fn(P(x), P(fm), P(wa), P(ba), P(wb), P(bb), P(out), b, t_len, c,
                    wa.shape[1], len(dils), ctypes.cast(d, ctypes.c_void_p),
                    _build.dtype_code(x.dtype), _build.stream_ptr(x)), "variant")
    return out


def ffn_call(fn, x, g, bl, w1, b1, w2, b2, shift, scale, gate):
    """The wrapper's launch with a variant's library; the f32 vectors as the
    wrapper makes them ([B, D] for shift/scale/gate)."""
    b, t, d = x.shape
    f = w1.shape[0]
    h = torch.empty((b * t, d), device=x.device, dtype=x.dtype)
    mid = torch.empty((b * t, f), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    P = _build.ptr
    _build.check(fn(P(x), P(g), P(bl), P(w1), P(b1), P(w2), P(b2), P(shift), P(scale),
                    P(gate), P(h), P(mid), P(out), b, t, d, f, 1e-5,
                    _build.dtype_code(x.dtype), _build.stream_ptr(x), 0), "variant")
    return out


def ffn_split(args) -> None:
    """Device time of each launch of the committed bf16 FFN (torch.profiler,
    mean of 20 calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ffn.fused_adaln_ffn(*args)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.count:
            cs.log(f"  committed, per launch: {e.self_device_time_total / e.count / 1e3:.4f} ms "
                   f"x{e.count} {e.key[:100]}")


def in_turns(label: str, calls: dict, reps: int, graphs: bool = False) -> dict:
    """Time each call in the order committed, variants, variants reversed,
    committed; print both readings of each (and, with graphs, both readings
    from replayed CUDA graphs, which it returns by call)."""
    names = list(calls)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cs.time_ms(calls[name], reps))
    replays = {name: [] for name in names}
    if graphs:
        for name in names + names[::-1]:
            replays[name].append(cs.graph_ms(calls[name], reps))
    for name in names:
        graph_txt = (f"; graph replay {' / '.join(f'{t:.4f}' for t in replays[name])} ms"
                     if graphs else "")
        cs.log(f"  {label} {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms"
               f"{graph_txt}")
    return replays


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    cs.log(smi.stdout.strip() or torch.cuda.get_device_name(0))
    kernels = [a for a in sys.argv[1:] if not a.startswith("--")] or list(VARIANTS)
    form = ("residual" if "--residual" in sys.argv  # one form alone
            else "bias" if "--bias" in sys.argv else None)
    if any(k not in VARIANTS for k in kernels):
        raise SystemExit(f"kernels: {', '.join(VARIANTS)} [--split] [--residual | --bias]")
    if "int8" in kernels and "w8a8_forms" not in kernels:
        kernels.append("w8a8_forms")  # the W8A8 product's rope and residual forms
    if "--split" in sys.argv:
        for kernel in SPLIT:
            VARIANTS[kernel] = variants_of(kernel, split=True)
    if form == "bias":  # the bias form's instances alone
        VARIANTS["linear"] = {name: subs for name, subs in VARIANTS["linear"].items()
                              if "bias form" in name or "128 x 128 tiles with" in name}
    elif form:  # the residual forms alone, with their variants and splits
        for kernel in ("linear", "w8a8_forms"):
            VARIANTS[kernel] = {name: subs for name, subs in VARIANTS[kernel].items()
                                if "residual form" in name
                                or name.startswith("split") and "rope form" not in name}
    _build.build_all()
    cs.log("build (bf16 kernels of each variant: ptxas registers and spills)")
    fns = build_variants(kernels)
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(0)
    dt = torch.bfloat16
    if "attention" in kernels:
        variants_attention(fns, gen, dt)
    if "attention_f32" in kernels:
        variants_attention_f32(fns, gen)
    if "resblock_chain" in kernels:
        variants_chain(fns, gen, dt)
    if "ffn" in kernels:
        variants_ffn(fns, gen, dt)
    if "int8" in kernels:
        variants_int8(fns, gen)
    if "w8a8_forms" in kernels:
        variants_w8a8_forms(fns, gen, form)
    if "quantize" in kernels:
        variants_quantize(fns, gen)
    if "ln_modulate" in kernels:
        variants_ln_modulate(fns, gen)
    if "ln_quantize" in kernels:
        variants_ln_quantize(fns, gen)
    if "silu_quantize" in kernels:
        variants_silu_quantize(fns, gen)
    if "conv1d" in kernels:
        variants_conv1d(fns, gen)
    if "linear" in kernels:
        if form in (None, "bias"):
            variants_linear(fns, gen, bias_only=form == "bias")
        if form != "bias":
            variants_linear_epilogues(fns, gen, form)
    return 0


# (M, K, N) of the W8A8 products of one b64/5-step batch (T=448) and of the
# TP int8 batch's int32 products (phase 11 (b) of chip_smoke.py)
CELL_INT8 = ((28672, 512, 512), (28672, 512, 2048), (28672, 2048, 512), (23680, 512, 512))
TP_INT8 = ((1792, 256, 512), (1792, 1024, 512))


def int8_call(fn, a, w, out_dtype, sx=None, ws=None, bias=None, silu=False):
    """One product through a variant's library: the int32 form, or the
    W8A8 epilogue's."""
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    P = _build.ptr
    if out_dtype == torch.int32:
        err = fn(P(a), P(w), P(out), m, n, k, _build.stream_ptr(a))
    else:
        err = fn(P(a), P(w), P(sx), P(ws), P(bias), P(out), m, n, k,
                 _build.dtype_code(out_dtype), _build.stream_ptr(a), int(silu))
    _build.check(err, "variant")
    return out


def variants_int8(fns, gen) -> None:
    cs.log("int8 product, ms per launch (W8A8 bf16 results at the cell's shapes; int32 at "
           "the TP shapes and the cell's)")
    cases = [(shape, torch.bfloat16, False) for shape in CELL_INT8 + TP_INT8]
    cases.append(((28672, 512, 2048), torch.bfloat16, True))  # ffn.in: silu in the epilogue
    cases += [(shape, torch.int32, False) for shape in TP_INT8 + CELL_INT8]
    for (m, k, n), out_dtype, silu in cases:
        a, w = (torch.randint(-127, 128, shape, generator=gen, device=cs.DEV).to(torch.int8)
                for shape in ((m, k), (n, k)))
        sx = torch.rand(m, generator=gen, device=cs.DEV) * 0.02
        ws = torch.rand(n, generator=gen, device=cs.DEV) * 0.01
        bias = 0.1 * torch.randn(n, generator=gen, device=cs.DEV)
        if out_dtype == torch.int32:
            ref = int8_matmul.int8_matmul_plain(a, w)
            calls = {"committed": lambda: int8_matmul.int8_matmul(a, w)}
            for name in VARIANTS["int8"]:
                fn = fns[("int8", name, "stk_int8_matmul")]
                calls[name] = lambda fn=fn: int8_call(fn, a, w, torch.int32)
        else:
            ref = w8a8.w8a8_matmul_plain(a, sx, w, ws, bias, out_dtype, silu=silu)
            calls = {"committed": lambda: w8a8.w8a8_matmul(a, sx, w, ws, bias, out_dtype,
                                                           silu=silu)}
            for name in VARIANTS["int8"]:
                if silu and name.startswith("earlier"):  # no silu in the earlier design
                    continue
                fn = fns[("int8", name)]
                calls[name] = lambda fn=fn: int8_call(fn, a, w, out_dtype, sx, ws, bias, silu)
        label = f"M{m} K{k} N{n} {str(out_dtype).split('.')[-1]}{' silu' if silu else ''}"
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 {label} {name}: not bit-equal to the plain version")
        cs.log(f"  int8 {label}: every variant bit-equal to the plain version")
        calls["torch._int_mm, the product alone (yardstick)"] = lambda: torch._int_mm(a, w.t())
        in_turns(label, calls, 20, graphs=True)


def quantize_call(fn, x):
    m, k = x.shape
    xq = torch.empty((m, k), device=x.device, dtype=torch.int8)
    sx = torch.empty((m,), device=x.device, dtype=torch.float32)
    P = _build.ptr
    _build.check(fn(P(x), P(xq), P(sx), m, k, _build.dtype_code(x.dtype), _build.stream_ptr(x)),
                 "variant")
    return xq, sx


def variants_quantize(fns, gen) -> None:
    cs.log("quantize, ms per launch (bf16 x): the cell's shapes, the TP int8 batch's, and "
           "M from 7,168 to 57,344 at K 512")
    shapes = ((28672, 512), (28672, 2048), (23680, 512), (1792, 256), (1792, 512),
              (1792, 1024), (7168, 512), (14336, 512), (57344, 512))
    for m, k in shapes:
        x = (3 * torch.randn((m, k), generator=gen, device=cs.DEV)).to(torch.bfloat16)
        x[0] = 0.0
        rq, rs = quantize.quantize_rows_plain(x)
        calls = {"committed": lambda: quantize.quantize_rows(x)}
        for name in VARIANTS["quantize"]:
            fn = fns[("quantize", name)]
            calls[name] = lambda fn=fn: quantize_call(fn, x)
        label = f"M{m} K{k}"
        for name, call in calls.items():
            if name.startswith("split"):
                continue
            xq, sx = call()
            torch.cuda.synchronize()
            if not (torch.equal(xq, rq) and torch.equal(sx.view(torch.int32),
                                                        rs.view(torch.int32))):
                raise AssertionError(f"quantize {label} {name}: not bit-equal")
        cs.log(f"  quantize {label}: every variant bit-equal to the plain version "
               f"(bound {cs.bound(m * k * 3 + 4 * m, 3.0 * m * k, torch.float32)[0]:.4f} ms)")
        in_turns(label, calls, 20, graphs=True)


def variants_ffn(fns, gen, dt) -> None:
    cs.log("AdaLN FFN, ms per call (all its launches)")
    d, f = 512, 2048
    for b, t in ((64, 448), (1, 448)):
        x = torch.randn((b, t, d), generator=gen, device=cs.DEV).to(dt)
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=cs.DEV)
        bl = 0.1 * torch.randn(d, generator=gen, device=cs.DEV)
        w1 = (torch.rand((f, d), generator=gen, device=cs.DEV) * 2 - 1).div(d ** 0.5).to(dt)
        w2 = (torch.rand((d, f), generator=gen, device=cs.DEV) * 2 - 1).div(f ** 0.5).to(dt)
        b1 = 0.1 * torch.randn(f, generator=gen, device=cs.DEV)
        b2 = 0.1 * torch.randn(d, generator=gen, device=cs.DEV)
        shift, scale, gate = ((0.5 * torch.randn((b, 1, d), generator=gen, device=cs.DEV))
                              .to(dt) for _ in range(3))
        args = (x, g, bl, w1, b1, w2, b2, shift, scale, gate)
        ref = ffn.adaln_ffn_plain(*args)
        flat = [v.float().reshape(b, d) for v in (shift, scale, gate)]
        calls = {"committed": lambda: ffn.fused_adaln_ffn(*args)}
        for name in VARIANTS["ffn"]:
            fn = fns[("ffn", name)]
            calls[name] = lambda fn=fn: ffn_call(fn, x, g, bl, w1, b1, w2, b2, *flat)
        hb = torch.randn((b * t, d), generator=gen, device=cs.DEV).to(dt)
        b1b, b2b = b1.to(dt), b2.to(dt)
        calls["the cuBLAS pair F.linear -> silu -> F.linear (yardstick)"] = (
            lambda: torch.nn.functional.linear(
                torch.nn.functional.silu(torch.nn.functional.linear(hb, w1, b1b)), w2, b2b))
        label = f"B{b} T{t} D{d} F{f}"
        for name, call in calls.items():
            if "cuBLAS" not in name:
                cs.compare(f"ffn {label} {name}", call(), ref, dt)
        in_turns(label, calls, 10, graphs=True)
        ffn_split(args)


def variants_attention(fns, gen, dt) -> None:
    cs.log("attention, ms per launch")
    for b, h, tq, tk, masked in ((64, 8, 448, 448, True), (64, 8, 448, 370, True),
                                 (64, 4, 320, 320, True), (64, 4, 320, 50, False),
                                 (1, 8, 448, 448, True), (1, 8, 448, 370, True),
                                 (1, 4, 320, 320, True), (1, 4, 320, 50, False)):
        q, k, v = (torch.randn((b, t, h, 64), generator=gen, device=cs.DEV).to(dt)
                   for t in (tq, tk, tk))
        mask = None
        if masked:
            lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen, device=cs.DEV)
            mask = (torch.arange(tk, device=cs.DEV)[None] < lens[:, None]).float()
        ref = attention.attention_plain(q, k, v, mask)
        calls = {"committed": lambda: attention.fused_attention(q, k, v, mask)}
        for name in VARIANTS["attention"]:
            fn = fns[("attention", name)]
            calls[name] = lambda fn=fn: attention_call(fn, q, k, v, mask)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bias = None if mask is None else ((1.0 - mask) * -1e9)[:, None, None, :].to(dt)
        calls["SDPA (yardstick)"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias)
        label = f"B{b} H{h} Tq{tq} Tk{tk}"
        for name, call in calls.items():
            if "SDPA" not in name and not name.startswith("split"):
                cs.compare(f"attention {label} {name}", call(), ref, dt)
        in_turns(label, calls, 20, graphs=True)


def variants_attention_f32(fns, gen) -> None:
    cs.log("attention f32, ms per launch")
    for b, h, t, d in ((64, 8, 448, 64), (64, 8, 448, 128)):
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=cs.DEV) for _ in range(3))
        lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=cs.DEV)
        mask = (torch.arange(t, device=cs.DEV)[None] < lens[:, None]).float()
        ref = attention.attention_plain(q, k, v, mask)
        calls = {"committed": lambda: attention.fused_attention(q, k, v, mask)}
        for name in VARIANTS["attention_f32"]:
            fn = fns[("attention_f32", name)]
            calls[name] = lambda fn=fn: attention_call(fn, q, k, v, mask)
        label = f"f32 B{b} H{h} T{t} Dh{d}"
        for name, call in calls.items():
            cs.compare(f"attention {label} {name}", call(), ref, torch.float32)
        in_turns(label, calls, 3, graphs=True)


def variants_chain(fns, gen, dt) -> None:
    cs.log("resblock chain, ms per launch")
    dils = (1, 3, 9)
    for b, t_len, c in ((64, 28672, 128), (64, 3584, 256), (1, 896, 256), (1, 7168, 128)):
        x = torch.randn((b, t_len, c), generator=gen, device=cs.DEV).to(dt)
        fm = torch.ones(t_len, device=cs.DEV)
        fm[-(t_len // 10):] = 0.0
        wa, wb = ((torch.rand((3, 3, c, c), generator=gen, device=cs.DEV) * 2 - 1)
                  .mul((3 * c) ** -0.5).to(dt) for _ in range(2))
        ba, bb = (0.1 * torch.randn((3, c), generator=gen, device=cs.DEV) for _ in range(2))
        args = (x, fm, wa, ba, wb, bb, dils)
        ref = vocoder_fused.resblock_chain_plain(*args)
        calls = {"committed": lambda: vocoder_fused.resblock_chain(*args)}
        for name in VARIANTS["resblock_chain"]:
            fn = fns[("resblock_chain", name)]
            calls[name] = lambda fn=fn: chain_call(fn, *args)
        label = f"C={c} B{b} x {t_len} frames"
        for name, call in calls.items():
            if not name.startswith("split"):
                cs.compare(f"chain {label} {name}", call(), ref, dt)
        in_turns(label, calls, 3 if b > 1 else 20, graphs=True)


def ln_call(fn, x, g, bl, shift, scale):
    """One LayerNorm through a variant's library, as the wrapper launches it."""
    b, t, d = x.shape
    mstride = 0
    if shift is not None:
        shift, mstride = batch_rows(shift, b, d, "shift")
        scale, _ = batch_rows(scale, b, d, "scale")
    out = torch.empty_like(x)
    P = _build.ptr
    _build.check(fn(P(x), P(g), P(bl), P(shift), P(scale), mstride, P(out), b * t, t, d, 1e-5,
                    _build.dtype_code(x.dtype), _build.stream_ptr(x)), "variant")
    return out


def variants_ln_modulate(fns, gen) -> None:
    cs.log("LayerNorm with the AdaLN modulation, ms per launch (bf16): the b64 cell's VE "
           "shape modulated and not, its TE/DP plain LayerNorm, a streamed chunk's VE shape")
    dt = torch.bfloat16
    for b, t, d, modulated in ((64, 448, 512, True), (64, 448, 512, False),
                               (64, 320, 256, False), (1, 448, 512, True)):
        x = (2 * torch.randn((b, t, d), generator=gen, device=cs.DEV) + 0.3).to(dt)
        g = 1.0 + 0.2 * torch.randn(d, generator=gen, device=cs.DEV)
        bl = 0.2 * torch.randn(d, generator=gen, device=cs.DEV)
        shift = scale = None
        if modulated:
            shift, scale = cs.modulation(gen, b, d, dt)[:2]
        ref = ln_modulate.ln_modulate(x, g, bl, shift, scale)
        calls = {"committed": lambda: ln_modulate.ln_modulate(x, g, bl, shift, scale)}
        for name in VARIANTS["ln_modulate"]:
            fn = fns[("ln_modulate", name)]
            calls[name] = lambda fn=fn: ln_call(fn, x, g, bl, shift, scale)
        if not modulated:
            calls["F.layer_norm (yardstick)"] = lambda: torch.nn.functional.layer_norm(
                x, (d,), g.to(dt), bl.to(dt))
        label = f"B{b} T{t} D{d}{' modulated' if modulated else ''}"
        same, matched = ln_modulate.one_step_match(ref, x, g, bl, shift, scale)
        if matched != 1.0:
            raise AssertionError(f"ln_modulate {label}: the committed kernel out of tolerance")
        for name, call in calls.items():
            if name.startswith("split") or "yardstick" in name:
                continue
            if not cs.bits_equal(call(), ref):
                raise AssertionError(f"ln_modulate {label} {name}: not bit-equal to the "
                                     f"committed kernel")
        cs.log(f"  ln_modulate {label}: every variant bit-equal to the committed kernel, "
               f"{same:.6f} of it bit-equal to the plain version (bound "
               f"{cs.bound(4 * b * t * d + 8 * d, 0, torch.float32)[0]:.4f} ms)")
        in_turns(label, calls, 20, graphs=True)


def variants_conv1d(fns, gen) -> None:
    cs.log("conv kernel, ms per launch (bf16) at the b64 cell's shapes")
    dt = torch.bfloat16
    for key in ((64, 448, 96, 512, 7, 1, "mask"),
                (64, 448, 512, 512, 3, 9, "silu_in+silu_out+mask"),
                (64, 448, 512, 512, 3, 1, "mask+residual"),
                (64, 448, 512, 2048, 5, 1, "silu_in+mask+fold8"),
                (64, 3584, 256, 1024, 5, 1, "silu_in+mask+fold8"),
                (64, 28672, 128, 32, 3, 1, "silu_in+tanh"),
                (64, 320, 256, 256, 5, 1, "silu_out+row_mask+residual")):
        b, t, cin, cout, k, d, _opts = key
        x, w, bias, kw = cs.conv_inputs(gen, key, dt)
        ref = conv1d.conv1d_fused(x, w, bias, **kw)
        calls = {"committed": lambda: conv1d.conv1d_fused(x, w, bias, **kw)}
        for name in VARIANTS["conv1d"]:
            fn = fns[("conv1d", name)]
            calls[name] = lambda fn=fn: conv_call(fn, x, w, bias, **kw)
        xt, wt, bt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous(), bias.to(dt)
        pad = d * (k - 1) // 2
        calls["F.conv1d, the bare conv (yardstick)"] = lambda: torch.nn.functional.conv1d(
            xt, wt, bt, padding=pad, dilation=d)
        label = f"B{b} T{t} {cin}->{cout} k{k} d{d} {_opts}"
        for name, call in calls.items():
            if "yardstick" in name or name.startswith("split"):
                continue
            if not cs.bits_equal(call(), ref):
                raise AssertionError(f"conv1d {label} {name}: not bit-equal to the committed "
                                     f"kernel")
        cs.log(f"  conv1d {label}: every variant bit-equal to the committed kernel")
        in_turns(label, calls, 10, graphs=True)


def conv_call(fn, x, w, bias, *, dilation, silu_in, silu_out, mask, fold, residual, tanh_f32,
              int16=False):
    """One conv through a variant's library, as the wrapper launches it."""
    b, t, cin = x.shape
    k, _, cout = w.shape
    mstride = 0 if mask is None or mask.dim() == 1 or mask.shape[0] == 1 else mask.shape[1]
    out = torch.empty((b, t, cout), device=x.device,
                      dtype=torch.int16 if int16 else torch.float32 if tanh_f32 else x.dtype)
    P = _build.ptr
    _build.check(fn(P(x), P(w), P(bias), P(mask), mstride, P(residual), P(out), b, t, cin, cout,
                    k, dilation, int(silu_in), int(silu_out), fold, int(tanh_f32),
                    _build.dtype_code(x.dtype), _build.stream_ptr(x), int(int16)), "variant")
    return out



# (M, K, N, form, the tail's rows a batch row) of the linear kernel's launches
# in one b64/5-step bf16 batch (T=448, L=320: chip_smoke.py phase 3 records
# them), with the launches a batch at each
CELL_LINEAR = {(64, 256, 1, "bias", 0): 1, (64, 256, 256, "silu", 0): 1,
               (64, 256, 512, "silu", 0): 5, (64, 512, 512, "bias", 0): 5,
               (64, 512, 1024, "bias", 0): 5, (64, 512, 4608, "bias", 0): 30,
               (3200, 128, 256, "bias", 0): 2, (3200, 128, 512, "bias", 0): 1,
               (3200, 256, 256, "bias", 0): 10, (20480, 256, 256, "bias", 0): 10,
               (20480, 256, 512, "bias", 0): 1, (20480, 256, 1024, "silu", 0): 10,
               (20480, 512, 512, "bias", 0): 1, (23680, 512, 512, "bias", 0): 6,
               (28672, 96, 512, "bias", 0): 5, (28672, 512, 96, "tail", 448): 5,
               (28672, 512, 512, "bias", 0): 30}


# (M, K, N, form, 0) of the bias form's launches in a streamed chunk (B = 1,
# T=448, L=320, Tk 370), with the launches a chunk
CHUNK_BIAS = {(1, 512, 4608, "bias", 0): 30, (448, 512, 512, "bias", 0): 30,
              (370, 512, 512, "bias", 0): 6, (320, 256, 256, "bias", 0): 10,
              (50, 256, 256, "bias", 0): 10, (448, 96, 512, "bias", 0): 5}


def linear_call(fn, x, w, b, silu=False, tail=None):
    """One linear through a variant's library, as the wrapper launches it."""
    n, k = w.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    x_in = dt = mask = None
    if tail is None:
        y = torch.empty((m, n), device=x.device, dtype=torch.bfloat16)
        t_rows, mode = 1, int(silu)
    else:
        x_in, dt, mask = tail
        y = torch.empty((m, n), device=x.device, dtype=torch.float32)
        t_rows, mode = x.shape[1], 2
    P = _build.ptr
    _build.check(fn(P(x2), P(w), P(b), P(x_in), P(mask), P(dt), P(y), m, n, k, t_rows, mode,
                    _build.stream_ptr(x)), "variant")
    return y.view(*x.shape[:-1], n)


def variants_linear(fns, gen, bias_only=False) -> None:
    """The bias, silu and tail forms at the b64 cell's shapes; with
    ``bias_only`` the bias form alone, at the cell's and a streamed chunk's
    shapes, on each of its instances."""
    cs.log("linear kernel, ms per launch (bf16) at the b64 cell's shapes, beside F.linear "
           "(cuBLAS's product with its bias epilogue) and the route it replaced")
    if not bias_only:
        cs.silu_every_bf16()
    shapes = ({key: n for key, n in {**CELL_LINEAR, **CHUNK_BIAS}.items() if key[3] == "bias"}
              if bias_only else CELL_LINEAR)
    for key, n_cell in shapes.items():
        m, k, n, form, t = key
        x, w, b, kw = cs.linear_inputs(gen, key)
        ref = linear.linear(x, w, b, **kw)
        calls = {"committed": lambda: linear.linear(x, w, b, **kw)}
        for name in VARIANTS["linear"]:
            if any(f in name for f in ROPE_OR_RESIDUAL):  # variants_linear_epilogues
                continue
            fn = fns[("linear", name)]
            calls[name] = lambda fn=fn: linear_call(fn, x, w, b, **kw)
        x2, bb = x.reshape(-1, k), b.to(torch.bfloat16)
        calls["F.linear(x, w, b), cuBLAS's bias epilogue (yardstick)"] = (
            lambda: torch.nn.functional.linear(x2, w, bb))
        calls["the replaced route: cuBLAS's product, then the elementwise passes"] = (
            lambda: linear.linear_plain(x, w, b, **kw))
        label = f"M{m} K{k} N{n} {form} ({n_cell} a {'chunk' if key in CHUNK_BIAS else 'batch'})"
        for name, call in calls.items():
            if (name == "committed" or "yardstick" in name or "replaced" in name
                    or name.startswith("split")):
                continue
            if not cs.bits_equal(call(), ref):
                raise AssertionError(f"linear {label} {name}: not bit-equal to the committed "
                                     f"kernel")
        cs.log(f"  linear {label}: every variant bit-equal to the committed kernel (the splits "
               f"unchecked)")
        in_turns(label, calls, 20, graphs=True)



# (M, K, N, form, the rope form's Dh or the gate's rows a batch row) of the
# Q, K and O projections' launches in one b64/5-step bf16 batch (T=448,
# L=320, fused_ffn=True), with the launches a batch, and the B = 1 shapes of
# a streamed chunk
CELL_EPILOGUES = {(28672, 512, 512, "rope", 64): 90, (23680, 512, 512, "rope", 64): 6,
                  (20480, 256, 256, "rope", 64): 20, (28672, 512, 512, "residual", 448): 60,
                  (20480, 256, 256, "residual", 0): 20, (20480, 1024, 256, "residual", 0): 10}
CHUNK_EPILOGUES = ((448, 512, 512, "rope", 64), (370, 512, 512, "rope", 64),
                   (320, 256, 256, "rope", 64), (448, 512, 512, "residual", 448),
                   (320, 256, 256, "residual", 0), (320, 1024, 256, "residual", 0))
ROPE_OR_RESIDUAL = ("rope form", "residual form")


def epilogue_call(fn, x, w, b, rope=None, n_heads=0, residual=None, gate=None):
    """One rope or residual form through a variant's library, as the wrapper
    launches it."""
    n, k = w.shape
    bsz, t = x.shape[:2]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    gstride = 0
    if gate is not None:
        gate, gstride = batch_rows(gate, bsz, n, "gate")
    cos, sin = rope or (None, None)
    dh = n // n_heads if rope is not None else 0
    y = torch.empty((m, n), device=x.device, dtype=torch.bfloat16)
    P = _build.ptr
    _build.check(fn(P(x2), P(w), P(b), P(cos), P(sin), P(residual), P(gate), gstride, P(y), m,
                    n, k, t, dh, 3 if rope is not None else 4, _build.stream_ptr(x)), "variant")
    return y.view(bsz, t, n_heads, dh) if rope is not None else y.view(bsz, t, n)


def variants_linear_epilogues(fns, gen, only=None) -> None:
    """The rope and residual forms (or the form ``only``) at the cell's and
    a streamed chunk's shapes: committed, the variants and splits that
    change them, the pair each replaced and the bias form alone; per batch,
    from graphs."""
    cs.log("linear kernel's rope and residual forms, ms per launch (bf16), beside the pair "
           "each replaced (F.linear, then the bias-and-rope or gated-residual kernel)")
    per_batch = {}
    for key in (*CELL_EPILOGUES, *CHUNK_EPILOGUES):
        m, k, n, form, t = key
        if only not in (None, form):
            continue
        n_cell = CELL_EPILOGUES.get(key, 0)
        x, w, b, kw = cs.linear_inputs(gen, key)
        ref = linear.linear(x, w, b, **kw)
        calls = {"committed": lambda: linear.linear(x, w, b, **kw)}
        for name in VARIANTS["linear"]:
            fn = fns.get(("linear", name, "stk_linear_epilogue"))
            mine = (form == "rope" if "rope form" in name else form == "residual"
                    if "residual form" in name else name.startswith("split"))
            if fn is not None and mine:
                calls[name] = lambda fn=fn: epilogue_call(fn, x, w, b, **kw)

        def pair():
            y = torch.nn.functional.linear(x, w)
            if form == "rope":
                return rope.bias_rope(y, b, *kw["rope"], kw["n_heads"])
            return gated_residual.gated_residual(kw["residual"], y, b, kw["gate"])
        calls["the pair it replaced (F.linear, then the bias-and-rope or gated-residual "
              "kernel)"] = pair
        calls["the bias form alone (yardstick)"] = lambda: linear.linear(x, w, b)
        label = (f"M{m} K{k} N{n} {form}{f' Dh {t}' if form == 'rope' else ''}"
                 f"{' gated' if form == 'residual' and t else ''} "
                 f"({f'{n_cell} a batch' if n_cell else 'a streamed chunk'})")
        for name, call in calls.items():
            if name == "committed" or name.startswith("split") or "alone" in name:
                continue
            if not cs.bits_equal(call(), ref):
                raise AssertionError(f"linear {label} {name}: not bit-equal to the committed "
                                     f"kernel")
        cs.log(f"  linear {label}: every variant and the pair bit-equal to the committed "
               f"kernel (the splits unchecked)")
        replays = in_turns(label, calls, 20, graphs=True)
        for name, ms in replays.items():
            if n_cell:
                per_batch[(form, name)] = per_batch.get((form, name), 0.0) + n_cell * sum(
                    ms) / len(ms)
    for (form, name), ms in per_batch.items():
        cs.log(f"  {form} form per b64/5-step batch at the cell's shapes, from graphs, {name}: "
               f"{ms:.4f} ms")


# (M, K, N, form, Dh or the gate's rows a batch row) of the W8A8 product's
# rope and residual forms in one b64/5-step int8 batch (T=448, the VE's Q, K
# and O and FFN-out), with the launches a batch, and a streamed chunk's
# (M 448; the cross K at the memory's 370 rows)
CELL_W8A8_FORMS = {(28672, 512, 512, "rope", 64): 90, (23680, 512, 512, "rope", 64): 6,
                   (28672, 512, 512, "residual", 448): 60,
                   (28672, 2048, 512, "residual", 448): 30}
CHUNK_W8A8_FORMS = ((448, 512, 512, "rope", 64), (370, 512, 512, "rope", 64),
                    (448, 512, 512, "residual", 448), (448, 2048, 512, "residual", 448))


def w8a8_form_call(fn, xq, sx, w, ws, bias, rope=None, n_heads=0, residual=None, gate=None):
    """One W8A8 rope or residual form through a variant's library, as the
    wrapper launches it."""
    m, k = xq.shape
    n = w.shape[0]
    bsz, t = (rope[0] if rope is not None else residual).shape[:2]
    gstride = 0
    if gate is not None:
        gate, gstride = batch_rows(gate, bsz, n, "gate")
    cos, sin = rope or (None, None)
    dh = n // n_heads if rope is not None else 0
    y = torch.empty((bsz, t, n), device=xq.device, dtype=torch.bfloat16)
    P = _build.ptr
    _build.check(fn(P(xq), P(w), P(sx), P(ws), P(bias), P(cos), P(sin), P(residual), P(gate),
                    gstride, P(y), m, n, k, t, dh, 3 if rope is not None else 4,
                    _build.stream_ptr(xq)), "variant")
    return y.view(bsz, t, n_heads, dh) if rope is not None else y


def variants_w8a8_forms(fns, gen, only=None) -> None:
    """The W8A8 product's rope and residual forms (or the form ``only``) at
    the int8 cell's and a streamed chunk's shapes: committed, the variants
    (and splits) of their instances, the pair each replaced (the W8A8
    product, then the bias-and-rope or gated-residual kernel) and the
    product alone; per batch, from graphs."""
    cs.log("W8A8 product's rope and residual forms, ms per launch (bf16), beside the pair "
           "each replaced (the W8A8 product, then the bias-and-rope or gated-residual kernel)")
    per_batch = {}
    bf16 = torch.bfloat16
    for key in (*CELL_W8A8_FORMS, *CHUNK_W8A8_FORMS):
        m, k, n, form, t = key
        if only not in (None, form):
            continue
        n_cell = CELL_W8A8_FORMS.get(key, 0)
        args, kw = cs.w8a8_form_inputs(gen, key)
        ref = w8a8.w8a8_matmul(*args, bf16, **kw)
        calls = {"committed": lambda: w8a8.w8a8_matmul(*args, bf16, **kw)}
        for name in VARIANTS["w8a8_forms"]:
            mine = (form == "rope" if "rope form" in name else form == "residual"
                    if "residual form" in name else name.startswith("split"))
            if mine:
                fn = fns[("w8a8_forms", name)]
                calls[name] = lambda fn=fn: w8a8_form_call(fn, *args, **kw)

        def pair():
            y = w8a8.w8a8_matmul(*args, bf16)
            if form == "rope":
                cos, sin = kw["rope"]
                return rope.bias_rope(y.view(*cos.shape[:2], n), None, cos, sin, kw["n_heads"])
            return gated_residual.gated_residual(kw["residual"], y.view(kw["residual"].shape),
                                                 None, kw["gate"])
        calls["the pair it replaced (the W8A8 product, then the bias-and-rope or "
              "gated-residual kernel)"] = pair
        calls["the W8A8 product alone (its bias form; yardstick)"] = (
            lambda: w8a8.w8a8_matmul(*args, bf16))
        label = (f"W8A8 M{m} K{k} N{n} {form}{f' Dh {t}' if form == 'rope' else ''}"
                 f"{' gated' if form == 'residual' and t else ''} "
                 f"({f'{n_cell} a batch' if n_cell else 'a streamed chunk'})")
        for name, call in calls.items():
            if name == "committed" or name.startswith("split") or "alone" in name:
                continue
            if not cs.bits_equal(call(), ref):
                raise AssertionError(f"{label} {name}: not bit-equal to the committed kernel")
        cs.log(f"  {label}: every variant and the pair bit-equal to the committed kernel "
               f"(the splits unchecked)")
        replays = in_turns(label, calls, 20, graphs=True)
        for name, ms in replays.items():
            if n_cell:
                per_batch[(form, name)] = per_batch.get((form, name), 0.0) + n_cell * sum(
                    ms) / len(ms)
    for (form, name), ms in per_batch.items():
        cs.log(f"  W8A8 {form} form per b64/5-step int8 batch at the cell's shapes, from "
               f"graphs, {name}: {ms:.4f} ms")


def variants_ln_quantize(fns, gen) -> None:
    """The LayerNorm's quantizing form at the int8 cell's VE shape and a
    streamed chunk's: committed and variants bit for bit the pair it
    replaced (the LayerNorm, then the quantize pass), timed in turns."""
    cs.log("the LayerNorm's quantizing form, ms per launch (bf16 in, int8 out)")
    dt = torch.bfloat16
    for b, t, d in ((64, 448, 512), (1, 448, 512)):
        x = (2 * torch.randn((b, t, d), generator=gen, device=cs.DEV) + 0.3).to(dt)
        g = 1.0 + 0.2 * torch.randn(d, generator=gen, device=cs.DEV)
        bl = 0.2 * torch.randn(d, generator=gen, device=cs.DEV)
        shift, scale = cs.modulation(gen, b, d, dt)[:2]

        def pair():
            return quantize.quantize_rows(
                ln_modulate.ln_modulate(x, g, bl, shift, scale).reshape(-1, d))
        ref = pair()
        calls = {"committed": lambda: ln_modulate.ln_modulate_quantize(x, g, bl, shift, scale)}
        for name in VARIANTS["ln_quantize"]:
            calls[name] = lambda fn=fns[("ln_quantize", name)]: ln_quantize_call(
                fn, x, g, bl, shift, scale)
        for name, call in calls.items():
            got = call()
            if not (torch.equal(got[0], ref[0]) and cs.bits_equal(got[1], ref[1])):
                raise AssertionError(f"ln_quantize {name}: not bit-equal to the pair")
        calls["the pair it replaced (the LayerNorm, then the quantize pass)"] = pair
        calls["the LayerNorm alone (bf16 rows; yardstick)"] = (
            lambda: ln_modulate.ln_modulate(x, g, bl, shift, scale))
        label = f"B{b} T{t} D{d} modulated"
        cs.log(f"  ln_quantize {label}: committed and variants bit-equal to the pair (bound "
               f"{cs.bound(3 * b * t * d + 4 * b * t + 8 * d, 0, torch.float32)[0]:.4f} ms)")
        in_turns(label, calls, 20, graphs=True)


def ln_quantize_call(fn, x, g, bl, shift, scale):
    b, t, d = x.shape
    shift, mstride = batch_rows(shift, b, d, "shift")
    scale, _ = batch_rows(scale, b, d, "scale")
    xq = torch.empty((b * t, d), device=x.device, dtype=torch.int8)
    sx = torch.empty((b * t,), device=x.device, dtype=torch.float32)
    P = _build.ptr
    _build.check(fn(P(x), P(g), P(bl), P(shift), P(scale), mstride, P(xq), P(sx), b * t, t, d,
                    1e-5, _build.stream_ptr(x)), "variant")
    return xq, sx


def real_ffn_in_operands() -> tuple:
    """The operands (xq, sx, w_q, w_scale, bias) of the first silu-quantize
    launch (block 0's FFN-in) of the int8 engine at the default config with
    chip_smoke.py's weights (random, from a seed) in one b64/5-step batch of
    the protocol texts, at the bucket its first batch takes: the network's
    own activations, whose values a random product does not give (many in a
    few exponents; with the weights' zero biases, exact zeros)."""
    import os

    from supertonic_tpu_torch import TTS
    from supertonic_tpu_torch.assets import save_params
    from supertonic_tpu_torch.config import TTSConfig

    assets = os.path.join(cs.OUT_DIR, "variants_assets")
    os.makedirs(assets, exist_ok=True)
    save_params(os.path.join(assets, "params.npz"), cs.smoke_params(TTSConfig()))
    cs.fresh_rate_dir("variants")
    seen = []
    launch = w8a8._silu_quantize

    def first(xq, sx, w_q, w_scale, bias, dtype):
        if not seen:
            seen.append(tuple(t.clone() for t in (xq, sx, w_q, w_scale, bias)))
        return launch(xq, sx, w_q, w_scale, bias, dtype)
    w8a8._silu_quantize = first
    try:
        tts = TTS(assets, precision="int8")
        tts.synthesize_batch([cs.TEXTS[i % 3] for i in range(64)], ["en"] * 64,
                             tts.get_voice_style("M1").tile(64), total_step=5)
    finally:
        w8a8._silu_quantize = launch
    return seen[0]


def silu_quantize_call(fn, xq, sx, w, ws, bias):
    m, k = xq.shape
    n = w.shape[0]
    hq = torch.empty((m, n), device=xq.device, dtype=torch.int8)
    hs = torch.empty((m,), device=xq.device, dtype=torch.float32)
    P = _build.ptr
    _build.check(fn(P(xq), P(w), P(sx), P(ws), P(bias), P(hq), P(hs), m, n, k,
                    _build.stream_ptr(xq)), "variant")
    return hq, hs


def variants_silu_quantize(fns, gen) -> None:
    """The W8A8 FFN-in's silu-quantize form at the int8 cell's shape and a
    streamed chunk's: committed and variants bit for bit the pair it
    replaced (the W8A8 silu form, then the quantize pass), timed in turns
    beside it and the silu form alone."""
    cs.log("the W8A8 silu-quantize form, ms per launch (int8 in and out)")
    cs.siluq_every_bf16()
    earlier = next(name for name in VARIANTS["silu_quantize"] if name.startswith("earlier"))
    bf16 = torch.bfloat16
    for m, k, n in ((28672, 512, 2048), (448, 512, 2048)):
        args, _kw = cs.w8a8_form_inputs(gen, (m, k, n, "residual", 0))

        def pair():
            return quantize.quantize_rows(w8a8.w8a8_matmul(*args, bf16, silu=True))
        ref = pair()
        calls = {"committed": lambda: w8a8.w8a8_matmul(*args, bf16, silu=True, quantize=True)}
        for name in VARIANTS["silu_quantize"]:
            calls[name] = lambda fn=fns[("silu_quantize", name)]: silu_quantize_call(fn, *args)
        for name, call in calls.items():
            if name.startswith("split"):
                continue
            got = call()
            if not (torch.equal(got[0], ref[0]) and cs.bits_equal(got[1], ref[1])):
                raise AssertionError(f"silu_quantize {name}: not bit-equal to the pair")
        calls["the pair it replaced (the W8A8 silu form, then the quantize pass)"] = pair
        calls["the W8A8 silu form alone (yardstick)"] = (
            lambda: w8a8.w8a8_matmul(*args, bf16, silu=True))
        label = f"W8A8 M{m} K{k} N{n}"
        bnd = cs.bound(m * k + n * k + 8 * m + 8 * n + m * n, 2.0 * m * n * k, torch.int8)[0]
        cs.log(f"  silu_quantize {label}: committed and variants bit-equal to the pair (bound "
               f"{bnd:.4f} ms; the splits unchecked)")
        in_turns(label, calls, 20, graphs=True)
        # the same without the edge rows (a zero row, a row at 127 whose values
        # reach past the table): every value on the table's fast path
        xr = quantize.quantize_rows_plain(torch.randn((m, k), generator=gen, device=cs.DEV))
        fast = (*xr, *args[2:])
        calls = {"committed": lambda: w8a8.w8a8_matmul(*fast, bf16, silu=True, quantize=True),
                 "earlier": lambda: silu_quantize_call(fns[("silu_quantize", earlier)], *fast),
                 "the pair": lambda: quantize.quantize_rows(
                     w8a8.w8a8_matmul(*fast, bf16, silu=True))}
        in_turns(f"{label}, random rows alone", calls, 20, graphs=True)
    # the network's own FFN-in operands
    args = real_ffn_in_operands()
    m, k = args[0].shape
    o = w8a8.w8a8_matmul_plain(*args, bf16).float().abs()
    cs.log(f"  the int8 network's FFN-in (block 0, M {m} K {k} N {args[2].shape[0]}): "
           f"{int((o == 0).sum())} zeros, {int(((o > 0) & (o < 2.0 ** -10)).sum())} values "
           f"below 2^-10, {int((o >= 256).sum())} from 256, max {float(o.max()):g}")
    ref = w8a8.w8a8_matmul(*args, bf16, silu=True, quantize=True)
    calls = {"committed": lambda: w8a8.w8a8_matmul(*args, bf16, silu=True, quantize=True),
             "earlier": lambda: silu_quantize_call(fns[("silu_quantize", earlier)], *args),
             "the pair": lambda: quantize.quantize_rows(w8a8.w8a8_matmul(*args, bf16, silu=True))}
    for name in VARIANTS["silu_quantize"]:
        if name.startswith("split") or name.startswith("the exact"):
            calls[name] = lambda fn=fns[("silu_quantize", name)]: silu_quantize_call(fn, *args)
    for name, call in calls.items():
        got = call()
        if not name.startswith("split") and not (
                torch.equal(got[0], ref[0]) and cs.bits_equal(got[1], ref[1])):
            raise AssertionError(f"silu_quantize on the network's operands, {name}: not "
                                 f"bit-equal to the committed kernel")
    in_turns(f"W8A8 M{m} K{k} N{args[2].shape[0]}, the network's own operands", calls, 20,
             graphs=True)
    # the bf16 linear's silu form (csrc/linear.cu's MODE_SILU, the silu table
    # where its tile holds it) beside the builds of the same source whose
    # silu is the exact sequence a value
    exact = [name for name in VARIANTS["silu_quantize"]
             if name.startswith("earlier") or name.startswith("the exact sequence")]
    cs.log("the bf16 linear's silu form, ms per launch, the table beside the exact sequence")
    for key in ((20480, 256, 1024, "silu", 0), (64, 256, 512, "silu", 0),
                (320, 256, 1024, "silu", 0)):
        x, w, b, kw = cs.linear_inputs(gen, key)
        ref = linear.linear(x, w, b, **kw)
        calls = {"committed": lambda: linear.linear(x, w, b, **kw)}
        for name in exact:
            calls[name] = lambda fn=fns[("silu_quantize", name, "stk_linear")]: linear_call(
                fn, x, w, b, **kw)
        for name, call in calls.items():
            if not cs.bits_equal(call(), ref):
                raise AssertionError(f"linear silu form {key} {name}: not bit-equal")
        label = (f"linear silu form M{key[0]} K{key[1]} N{key[2]} "
                 f"({linear.kernel_instance(*key[:3], 'silu')})")
        cs.log(f"  {label}: bit-equal to the exact sequence's builds")
        in_turns(label, calls, 20, graphs=True)


if __name__ == "__main__":
    sys.exit(main())
