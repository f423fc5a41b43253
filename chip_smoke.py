#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``supertonic_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card, a few minutes
    python3 chip_smoke.py --profile  # add a torch.profiler breakdown of
                                     # one b64/5-step batch to phase 3
    python3 chip_smoke.py --pin-rate # phases 3 and 4 at the latent buckets
                                     # of a fixed 1/11 s/char rate (T=640
                                     # for the b64 cell), to compare with
                                     # a tree from before the rate cache
    python3 chip_smoke.py --mesh-only # phases 1, 2 and 11 (a)-(b) alone; on
                                     # several cards DP over all of them
                                     # and TP over cuda:0 and cuda:1 too

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile every kernel in supertonic_tpu_torch/csrc with nvcc,
               printing ptxas's register and spill report; count the wgmma
               (HGMMA) and TMA-load (UTMALDG) instructions of the bf16
               attention, FFN and chain libraries, the integer wgmma
               (IGMMA), TMA loads and stores (UTMALDG, UTMASTG) and mma.sync
               (IMMA) of the int8 library and the bulk copies (UBLKCP) of
               the quantize library (cuobjdump -sass; a library without
               them, or an int8 library with IMMA, fails) and print the
               tiles each chose (the chain's at the b64 cell's shapes and
               the two vocoder windows; the int8 library's instances)
  3. main    — TTS() at the default 66M config (bf16, random weights made
               from a seed, zero-init heads perturbed) answers the three
               protocol texts through ``synthesize`` and 16 texts through
               ``synthesize_batch``; checks the audio and each kernel's
               launch counter; then times b64 batches, records the
               shapes each kernel wrapper is given in one b64/5-step batch
               (the cell's shapes; exactly the per-batch counts, credited
               by the replay of its program) and the host time a dispatch
               spends on its noise generator, its event and its queued
               copies. Every batch runs as a replay of the fused program
               (a CUDA graph captured per static shape at first use): the
               cell's program is held bit-equal to synthesize_fused run
               eagerly with the same generator seed, and one replayed
               batch runs under torch.profiler, which counts its host
               launch calls (at most 32), finds each hand-written kernel
               in its device trace as often as the counters say, and gives
               device busy and the idle share against the reps' wall;
               each program's capture seconds and memory are printed;
               then the same cell through SynthesisEngine(fused_ffn=False),
               the JAX engine's default (the AdaLN FFN as two cuBLAS
               products and a silu): its launches, b64 audio-sec/s beside
               the default's, and the bf16 wav distance between the two;
               and through SynthesisEngine(fused_resblocks=False) (the
               vocoder's chains as torch convs, JAX's TTS_VOC_FUSED unset):
               no chain launch, b64/5-step audio-sec/s beside the default's,
               and the bf16 wav distance to an engine built under
               TTS_VOC_FUSED=0 (no chain launch either)
               Every phase that counts launches also counts the block's
               three elementwise kernels: the LayerNorm with the AdaLN
               modulation, the bias add with the rotary embedding and the
               gated residual, the conv kernel (the vocoder's convs
               and the text encoder's prenet with the ops around them)
               and the linear kernel (every bf16 layers.linear with its
               bias, silu or flow-step tail, and every bf16 Q and K
               projection with its rotary embedding and O or FFN-out with
               the gated residual: the bias-and-rope and gated-residual
               kernels launch on neither b64 path); exact per-batch
               counts in PER_BATCH; the replayed bf16 batch's trace holds
               no library matrix product
  4. int8    — the same through TTS(precision="int8"), the W8A8 path: the
               VE block linears through the int8 product with its
               rescale-and-bias epilogue and, on the linear kernel's GEMM
               with its s8 operand, its rope form (Q and K), residual form
               (O and FFN-out) and silu-quantize form (the FFN-in, writing
               the FFN-out's xq and sx): the W8A8 products by form exactly
               W8A8_FORMS; their inputs quantized by the LayerNorm kernel's
               quantizing form (ln1 for self Q, K and V, ln2 for cross Q,
               ln3 for the FFN-in: LN_QUANTIZE_FORM launches), by the
               silu-quantize form, or by the quantize kernel (self and
               cross O, one pass for cross K and V); no fused FFN
  5. kernels — each kernel against its plain PyTorch version on the card,
               at the cell's shapes recorded in phases 3 and 4, at the
               smaller shapes of a T=256 batch and at the tile edges of
               the bf16 kernels, in f32 and bf16 (the int8 product, the
               quantize pass and the W8A8 product bit for bit), with
               kernel / plain / library times and bounds (each kernel
               also from a replayed CUDA graph, the library call too;
               torch._int_mm is the library time of the int32 product and,
               as the product alone, of the W8A8 product), and the earlier
               kernels' times beside this run's at the cell's shapes
               (EARLIER_MS); also at every shape that phase 7 recorded
               (the batcher's groups at B <= 32, streaming and progress at
               B=1, the chain on the vocoder windows, the int8 server's
               quantize and W8A8 shapes), timed where a streamed chunk
               launches them; at the attention's whole-row form's edges
               (Tk at ROW_KEYS - 1, ROW_KEYS and one past it, a consumer
               warpgroup's keys all padding or all masked, fully masked
               rows across and within its split); at the other widths
               (every bf16 attention
               instance, Dh 12 to 256, and Dh 320 past them, in both types,
               timed at Dh 192 and 256; the FFN's K and N tails; every chain
               instance and padded channel counts; chains of conv size 5,
               of five pairs and of a lone pair at the fused kernels'
               largest reach, run as more than one launch where a tile
               cannot hold them; pairs past that reach, k 3 at dilation 32
               and k 11 at dilation 5, alone and in chains, which run as
               per-conv launches) and, timed, at every shape phase 12
               recorded; the fused kernels' reach constant
               (vocoder_fused.MAX_PAIR_REACH) against the library's; the
               block's three elementwise kernels at every shape phases 3,
               4, 7, 11 and 12 recorded and at edges (bias_rope and
               gated_residual bit for bit, ln_modulate within
               ln_modulate.F32_ATOL in f32 and, in bf16, its one-step rule:
               ln_modulate.one_step_match), timed in bf16 at the cell's
               shapes beside F.layer_norm and torch.addcmul, the
               LayerNorm also beside its earlier design (EARLIER_MS); the
               conv kernel at every shape phases 3 (all three engines),
               4, 7, 11 and 12 recorded and at edges (f32 within
               conv1d.F32_RTOL, bf16 by conv1d.bf16_within), timed in bf16
               at the cell's shapes beside F.conv1d, the bare conv, and
               the earlier design (EARLIER_MS), its int16 head bit for bit
               the encoding of its f32 tanh; the W8A8 product's silu form
               bit for bit F.silu of its output, its rope and residual
               forms bit for bit the product followed by the plain
               rotation or gated residual at the int8 cell's, a streamed
               chunk's and phase 12's shapes and at edges (every instance,
               Dh 12 to 256, K 2,048, gates of B rows, one row, odd
               offsets, none), timed beside the pair each replaces (the
               W8A8 product, then the bias-and-rope or gated-residual
               kernel); the LayerNorm's quantizing form and the W8A8
               silu-quantize form bit for bit the pair each replaces (the
               LayerNorm or the silu form, then the quantize kernel) at the
               int8 cell's, a streamed chunk's and phase 12's VE widths
               and at edges (one row, rows off the tiles, one row of
               modulation for all, no modulation, clusters of 1 to 16
               blocks), timed beside those pairs, and first the
               silu-quantize form and the W8A8 silu form at every finite
               bf16 value (their silu tables); the linear kernel at
               every shape phases 3, 4, 7, 11 and 12 recorded and at edges
               (the bias and silu forms by linear.bf16_within, silu bit for
               bit F.silu of the kernel's bias form, the tail bit for bit
               linear.euler_tail of it, the rope and residual forms bit for
               bit the plain rotation and gated residual of it, at every
               head width), first the silu form at every
               finite bf16 value, timed at the cell's and a streamed
               chunk's shapes beside F.linear(x, w, b), the replaced design
               (EARLIER_MS) and, for the rope and residual forms, the pair
               each replaces (F.linear, then the bias-and-rope or
               gated-residual kernel)
  6. whole   — one batch through the whole path in f32 on the card
               (kernels) and on the CPU (plain versions); the W8A8 linears
               of one VE block (and the rope, residual and silu-quantize
               forms of its self Q, FFN-out and FFN-in), card vs CPU; int8
               against bf16 on the
               card; one b64 batch with fused projections against the
               unfused one, in bf16 and int8; injected noise throughout
  7. serving — runs after phase 4, before phase 5: make_server(TTS()) on a
               local port with the batcher answers 64 concurrent /tts
               requests (checked, coalesced), every other endpoint, and a
               ~900-character /tts/stream whose first audio must arrive
               before /tts of the same text completes (medians of three
               turns after a warm one); stream_windows,
               windowed against whole vocoding (f32 held to 1e-5, bf16
               printed; the int16 windows from the head's epilogue each the
               encoding of their f32 samples, and bit-equal to the whole
               vocoding's where the f32 samples are), infer_with_progress
               and mu-law egress; an int8
               server; every kernel of each path must launch. Prints TTFA,
               p50/p95 latency and served audio-sec/s beside the card. The
               batcher's groups, the streamed chunks' flow and the windows
               (those of the windowed-vs-whole check too) are replays of
               their programs
  8. programs — in f32 and bf16, a fused batch at B=4, the B=1 flow with
               the halo padding and three vocoder windows: each replay
               bit-equal to the eager function with the same generator seed
  9. graph bundle — the smoke params exported as the reference's four ONNX
               graphs (assets/onnx_export.py) into build/smoke: the automap
               round trip bit-equal; TTS(<bundle>) in f32 (the fused graph
               backend under the engine) against the native f32 engine at
               B=4 on injected noise, card against CPU, a replayed fused
               batch bit-equal to its eager run with its host launch calls
               under torch.profiler, the per-call adapter against it; b64
               audio-sec/s at "default" precision with bf16 storage beside
               phase 3's native bf16 (at phase 3's learned rate, so at the
               same buckets), and capture seconds and pool growth
 10. the rest of the single-card surface — compat.load_text_to_speech:
               __call__ and batch on the card, each run_* card vs CPU in
               f32, the ONNX probe on phase 9's bundle; python -m
               supertonic_tpu_torch writes a WAV; infer_with_progress and
               infer_batch(noise=...) through their programs bit-equal to
               an eager twin (f32, bf16), with host launch calls under
               torch.profiler and the progress wall beside the eager one;
               two replayed b64 batches under utils.timing.device_trace,
               the second naming each hand-written kernel as often as the
               per-batch counts say; the native C++ frontend built from
               the port's sources, equal to the Python frontend, serving
               under TTS_NATIVE_FRONTEND=1; the vocoder's up_matmul against
               the conv path at b64 and TTS_VOC_UP_MATMUL=1 in an engine;
               python -m supertonic_tpu_torch.tools.smoke_test (the CLI in
               its four modes, the bundle exported from the smoke params).
               Phase 6's int8 vs bf16 check also prints log-mel SNR and MCD
 11. the mesh — (a)-(d) run after phase 7, before phase 5, so that phase 5
               also checks every kernel at the shapes the mesh gave it:
               (a) SynthesisEngine(mesh=make_mesh(devices=[cuda:0,
               cuda:0])) at the b64/5-step bf16 cell: audio, launches
               exactly twice a B=32 shard's, durations bit-equal to the
               single-device engine with the same seed in bf16 and (B=8)
               f32, the f32 wav within 1e-5 and the bf16 wav's relative L2
               at most 0.01, audio-sec/s beside the single device (over
               every card too, where there are several); (b) model=2 over
               [cuda:0, cuda:0] at B=4, eager: f32 within 5e-5 of the
               single device, attention at half the heads, no FFN-kernel
               launch, VE block 0's W8A8 linears sharded bit-equal to
               unsharded (f32 and bf16 out), the int8 engine against
               single-device int8 (printed), whose int32-product launches
               the kernel line reports; (c) two processes on a gloo control
               group (``--multihost-worker``), each with local_mesh() and
               its host_shard; no config is a no-op, a bad coordinator
               raises; (d) two port servers behind the router: 16 /tts over
               both, then one killed and the rest served by failover. (e),
               last: phase 9's bundle under a DP mesh against the single
               device (f32, 3e-5), python -m
               supertonic_tpu_torch.tools.parity_check --skip-ort exits 0
               and tools.bench_onnx_backend prints both modes
 12. widths — runs after phase 11 (d), before phase 5: the whole path at
               five configs off the default widths (the tests' tiny dims:
               Dh 16 and 32, FFN D 64 F 256, chains at C 64, 32, 16; a
               reference tts.json with proj_out.idim 384: TE Dh 96; the VE
               at Dh 128 with the vocoder's chains at 384 and 192; a
               reference tts.json with proj_out.idim 1024, TE Dh 256, and
               the vocoder's chains at conv size 7, pairs reaching 30
               frames, per-conv launches in f32 at C 256; and, with both
               fused_resblocks settings, the tiny dims with every conv off
               the earlier conv kernel's domain: 15 latent channels into
               the pre conv, a head of 15, vocoder channels (36, 20),
               resblocks of size 11 at dilations (1, 3, 5), even sizes at
               the up convs and the prenet), depth
               cut, through TTS(<its assets>): f32 on the card against the
               CPU on injected noise (B=2, 2 steps; 1e-5 in the wav) and
               bf16 synthesize_batch (finite, RMS); attention, the FFN,
               the chain and the block's three elementwise kernels must
               launch at every width the config gives them (in bf16 the
               rotation's and the gated residual's: the linear kernel's
               rope forms at every head width, its residual forms at every
               model width, and the two elementwise kernels not at all),
               and no plain version may see a CUDA tensor
Each TTS() reads and writes its learned speaking rate under a fresh folder
of supertonic_tpu_torch/build/smoke/rates, so no earlier run steers the
latent buckets. The line before the last is a JSON object of per-kernel numbers, taken at
the cell's shape that spends the most kernel time per batch (the W8A8
product's rope, residual and silu-quantize forms and the LayerNorm's
quantizing form as entries of their own, "w8a8_matmul rope form",
"w8a8_matmul residual form", "w8a8_matmul silu-quantize form" and
"ln_modulate quantize form", their launches those of the int8 b64 batch;
the linear kernel's residual form as "linear residual form", its launches
those of the bf16 batch; that entry and the W8A8 rope and residual
forms' also carry "earlier_ms", the replaced design's time (null where it
has none), and "pair_ms", the pair each replaces, from a graph;
the bias-and-rope and gated-residual kernels, off both b64 paths, at
0 launches with a row at the int8 VE's shapes); the last line is
``{"ok": true, "device": {...}}``.

f32 checks run with TF32 disabled for matmuls and cuDNN convs, so the plain
versions on the card are true f32 references.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np
import torch

from supertonic_tpu_torch import TTS, TTSConfig, ops
from supertonic_tpu_torch.assets import save_params
from supertonic_tpu_torch.engine import SynthesisEngine, programs, synthesis
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import (count_params, fuse_projections, init_all,
                                         quantize_params)
from supertonic_tpu_torch.models import layers
from supertonic_tpu_torch.ops import (_build, attention, conv1d, ffn, gated_residual,
                                      int8_matmul, linear, ln_modulate, quantize, rope,
                                      vocoder_fused, w8a8)
from supertonic_tpu_torch.serve.http_server import make_server
from supertonic_tpu_torch.utils import read_wav

# protocol texts of the JAX package's bench harness (59 / 152 / 266 chars)
SHORT_TEXT = "The quick brown fox jumps over the lazy dog near the creek."
MID_TEXT = (
    "This morning, I took a walk in the park, and the sound of the birds "
    "and the breeze felt so pleasant that I stopped to listen a while "
    "longer there today.")
LONG_TEXT = (
    "This morning, I took a walk in the park, and the sound of the birds "
    "and the breeze was so pleasant that I stopped for a long time just to "
    "listen. Later, as the sun rose higher over the trees, the path "
    "slowly filled with joggers, bikers, and children going to school.")
TEXTS = (SHORT_TEXT, MID_TEXT, LONG_TEXT)
assert tuple(map(len, TEXTS)) == (59, 152, 266)

PEAK_BYTES = 3.35e12                       # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
            torch.float32: 67e12,          # f32 outside the tensor cores
            torch.int8: 1979e12}           # dense tensor-core int8
TOL = {torch.float32: 1e-4,   # reduction-order noise of f32 sums
       torch.bfloat16: 2e-2}  # one bf16 rounding flip of an intermediate
WHOLE_PATH_WAV_ATOL = 1e-5    # f32 through ~60 layers, card vs CPU sum order
WHOLE_PATH_DUR_RTOL = 1e-5
# int8 vs bf16 wav on the card, 2 steps: read 0.008661 on an H100; the bf16
# vocoder's last roundings alone leave ~0.006 between two bf16 runs that
# differ upstream, so phase 6's W8A8 linears check is the one that
# separates a right quantization from none
INT8_WAV_REL_L2 = (0.003, 0.03)
FUSED_WAV_REL_L2_MAX = 0.03   # fused vs unfused projections, b64, on the card
# kernel launches per b64/5-step batch at the default config (TE 6 blocks, DP
# 4, VE 6 at 5 steps): attention 2 per VE block and step + 20 in TE/DP, the
# fused FFN 1 per VE block and step, W8A8 linears (a quantize pass and a
# W8A8 product each) 8 per VE block and step + 2 per block for the cross
# K/V; the int32 int8 product is off the path. The block's elementwise
# kernels: the LayerNorm 3 per TE/DP block + 2 per VE block and step (3
# where the FFN is unfused: fused_ffn=False and the int8 path) + the three
# networks' ln_out (1 per step in the VE): 32 + 65 (97); the bias and
# rotation and the gated residual never on the b64 path: a bf16 linear takes
# them in its epilogue, the linear kernel's or (W8A8, the int8 path's VE)
# the W8A8 product's: its rope form at the VE's self Q and K and cross Q a
# block and step (90) + its cross K once a batch (6): 96; its residual form
# after each VE sublayer (the FFN is unfused there): 90; 252 W8A8 products
# (96 rope, 90 residual, 30 silu-quantize, 36 bias) on 66 quantize passes:
# self Q, K and V share one, cross K and V another (252 - 60 - 6 = 186), of
# which the VE's ln1, ln2 and ln3 (90, their outputs read by W8A8 linears
# alone) are the LayerNorm kernel's quantizing form, counted as ln_modulate
# (so 127 LayerNorm launches still, 90 of them quantizing), and the FFN-out's
# input (30) the FFN-in's silu-quantize form. The conv kernel: the text
# encoder's two prenet convs and the vocoder's pre conv, six C 512 pre_res
# convs (a chain past the chain kernel's C 384), two up convs and the head:
# 12; with fused_resblocks=False also the six convs of each of the two fine
# chains: 24.
# The linear kernel (every bf16 layers.linear of a plain Linear, with the
# rotation or the gated residual in its epilogue): the self and cross V and
# the cross Q and K (no rotation) of each TE and DP block (40), each VE
# block's self V and AdaLN a step (60), its cross V once (6), in_proj,
# time_mlp2 and adaln_out a step (15), the three style and text
# projections, proj_out and the rate head's second linear (6): 127 bias;
# each TE and DP block's FFN-in, the rate head's first linear and time_mlp1
# a step: 16 silu; out_proj with the Euler update a step: 5 tail; the self
# Q and K of each TE and DP block (20), each VE block's self Q and K and
# cross Q a step (90) and its cross K once (6): 116 rope; each TE and DP
# block's self O, cross O and FFN-out (30) and each VE block's self and
# cross O a step (60): 90 residual; 354 (tests/test_torch_linear.py counts
# the same forms on the CPU). With fused_ffn=False also each VE block's
# FFN-in (+30 silu) and FFN-out (+30 residual) a step: 414. On the int8
# path the VE blocks' Q, K, V, O and FFN linears are W8A8: 354 - 36 (its
# self and cross V) - 96 (its rope forms) - 60 (its residual forms) = 162.
_BLOCK = {"ln_modulate": 97, "bias_rope": 0, "gated_residual": 0, "conv1d": 12}
_BLOCK_UNFUSED_FFN = {"ln_modulate": 127, "bias_rope": 0, "gated_residual": 0, "conv1d": 12}
PER_BATCH = {
    "bf16": {"attention": 80, "adaln_ffn": 30, "resblock_chain": 2, "int8_matmul": 0,
             "w8a8_matmul": 0, "quantize": 0, **_BLOCK, "linear": 354},
    "int8": {"attention": 80, "adaln_ffn": 0, "resblock_chain": 2, "int8_matmul": 0,
             "w8a8_matmul": 252, "quantize": 66, **_BLOCK_UNFUSED_FFN, "linear": 162},
    # SynthesisEngine(fused_ffn=False): the AdaLN FFN as linear, silu, linear
    "bf16 unfused FFN": {"attention": 80, "adaln_ffn": 0, "resblock_chain": 2,
                         "int8_matmul": 0, "w8a8_matmul": 0, "quantize": 0,
                         **_BLOCK_UNFUSED_FFN, "linear": 414},
    # SynthesisEngine(fused_resblocks=False): every chain as _resblock's convs
    "bf16 unfused resblocks": {"attention": 80, "adaln_ffn": 30, "resblock_chain": 0,
                               "int8_matmul": 0, "w8a8_matmul": 0, "quantize": 0,
                               **_BLOCK, "conv1d": 24, "linear": 354},
}
BLOCK_KERNELS = tuple(_BLOCK)  # and the conv kernel
# the block kernels a bf16 path launches (the rotation and the gated
# residual are the linear kernel's epilogue there, and the int8 path's the
# W8A8 product's)
BF16_BLOCK_KERNELS = ("ln_modulate", "conv1d")
EPILOGUE_KERNELS = ("bias_rope", "gated_residual")
# the W8A8 product's launches of a b64/5-step int8 batch by form (the bias
# and silu forms' shape keys are (M, K, N); the rope and residual forms'
# (M, K, N, form, Dh or the gate's rows a batch row), as the linear kernel's)
W8A8_FORMS = {"rope": 96, "residual": 90, "silu_quantize": 30, "bias or silu": 36}
# the LayerNorm kernel's quantizing form in a b64/5-step int8 batch (its shape
# keys (B, T, D, modulated, "quantize")): the VE's ln1, ln2 and ln3
LN_QUANTIZE_FORM = 90
# a bf16 b64/5-step batch with fused projections (models.fuse_projections):
# the self Q and K split from each QKV product and the VE's cross K from its
# KV product rotate in the bias-and-rope kernel (20 + 60 + 6); the linear
# kernel takes 354 - 96 launches (QKV one, not three; KV one, not two)
FUSED_BF16 = {"bias_rope": 86, "linear": 258}
W8A8_KERNELS = ("w8a8_matmul", "quantize")
# with fused projections: qkv, o, cross q, o, ffn in, out per VE block and
# step, the cross kv once per block
FUSED_W8A8_LINEARS = 6 * (6 * 5 + 1)
# and in int8: the self Q and K split from the TE's and DP's and the VE's
# QKV products and the VE's cross K from its KV product rotate in the
# bias-and-rope kernel (20 + 60 + 6), the VE's cross Q (no fused slice) in
# the W8A8 product's rope form; the linear kernel takes 162 - 20 (the TE's
# and DP's rope forms) - 10 (their cross K, in the KV product); the W8A8
# products FUSED_W8A8_LINEARS on the unfused batch's 66 quantize passes (the
# QKV product reads ln1's quantizing form, as the Q, K and V did)
FUSED_INT8 = {"bias_rope": 86, "linear": 132, "w8a8_matmul": FUSED_W8A8_LINEARS, "quantize": 66}
# int8 products at an N whose rows no TMA store takes (odd, and 4 bytes of
# bf16): the instances that store from the registers, element by element
ODD_N = ((1, 32, 37), (37, 512, 37), (37, 2048, 7), (130, 512, 2))
# a row of x.5 values whose amax is 127, so sx = 1 exactly: rounds half to even
HALVES = (127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5)
SOURCES = {
    "attention": ("supertonic_tpu_torch/csrc/attention.cu",
                  "supertonic_tpu/ops/attention.py:52"),
    "adaln_ffn": ("supertonic_tpu_torch/csrc/ffn.cu",
                  "supertonic_tpu/ops/ffn.py:31"),
    "resblock_chain": ("supertonic_tpu_torch/csrc/resblock_chain.cu",
                       "supertonic_tpu/ops/vocoder_fused.py:54"),
    "int8_matmul": ("supertonic_tpu_torch/csrc/int8_matmul.cu",
                    "tools/int8_microbench.py:43"),
    # the same kernel with the W8A8 linear's rescale-and-bias epilogue
    "w8a8_matmul": ("supertonic_tpu_torch/csrc/int8_matmul.cu",
                    "tools/int8_microbench.py:43"),
    # the W8A8 product's rope and residual forms: the linear kernel's GEMM
    # with its s8 operand and the rescale (the int8 Q, K and O output fusion)
    "w8a8_matmul rope form": ("supertonic_tpu_torch/csrc/linear.cu",
                              "tools/int8_microbench.py:43"),
    "w8a8_matmul residual form": ("supertonic_tpu_torch/csrc/linear.cu",
                                  "tools/int8_microbench.py:43"),
    # the FFN-in's silu form writing the FFN-out's quantize pass (xq, sx):
    # the same GEMM, W resident, a cluster a row block
    "w8a8_matmul silu-quantize form": ("supertonic_tpu_torch/csrc/linear.cu",
                                       "tools/int8_microbench.py:43"),
    # the W8A8 linear's quantize prologue (XLA ops in the JAX package)
    "quantize": ("supertonic_tpu_torch/csrc/quantize.cu",
                 "supertonic_tpu/models/layers.py:84"),
    # the transformer block's XLA fusions: layer_norm with _modulate, the
    # bias add with apply_rope, and the gated residual
    "ln_modulate": ("supertonic_tpu_torch/csrc/ln_modulate.cu",
                    "supertonic_tpu/models/layers.py:106"),
    # its quantizing form: _modulate with the first half of _linear_w8a8
    "ln_modulate quantize form": ("supertonic_tpu_torch/csrc/ln_modulate.cu",
                                  "supertonic_tpu/models/layers.py:84"),
    "bias_rope": ("supertonic_tpu_torch/csrc/rope.cu", "supertonic_tpu/models/layers.py:162"),
    "gated_residual": ("supertonic_tpu_torch/csrc/gated_residual.cu",
                       "supertonic_tpu/models/layers.py:428"),
    # the XLA fusions of layers.conv1d with the ops its callers put around
    # it (the vocoder's masks, silu, depth-to-space, residual and tanh; the
    # text encoder's prenet)
    "conv1d": ("supertonic_tpu_torch/csrc/conv1d.cu", "supertonic_tpu/models/layers.py:127"),
    # the XLA output fusion of layers.linear's bf16 dot: JAX's bias rounding,
    # the callers' silu and the flow step's Euler update
    "linear": ("supertonic_tpu_torch/csrc/linear.cu", "supertonic_tpu/models/layers.py:55"),
    # its residual form as an entry of its own (the bf16 O and FFN-out with
    # x + gate * linear(...)), its rows copies of the linear rows at its shapes
    "linear residual form": ("supertonic_tpu_torch/csrc/linear.cu",
                             "supertonic_tpu/models/layers.py:428"),
}
# ms per launch (bf16; int8 for the int8 product) of the designs that the
# kernels on the path replaced, printed beside this run's times; keys are
# the shapes ops.record_launches tallies. Attention: the two-pass design that
# the whole-row form replaced at bf16 Dh 64
# (supertonic_tpu_torch/csrc/earlier/attention_two_pass.cu), this script's
# host-launched times at the b64 cell's shapes (L=320, T=448) and a streamed
# chunk's B=1 shapes before the replacement. The AdaLN FFN: the mma.sync
# design it replaced (supertonic_tpu_torch/csrc/earlier/) at the same
# shapes, kernel_variants.py's "earlier" rows (CUDA events, as time_ms). Both
# on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6). The chain: the
# design it replaced (two m64n64k16 products a k-step, the epilogue in f32:
# kernel_variants.py's substitutions on csrc/resblock_chain.cu), at the b64
# cell's two shapes (T=448) and the two vocoder windows of a streamed chunk,
# kernel_variants.py's "earlier" rows (host launches, mean of the two
# readings) on the same card (PERF.md section 6). The int8 products and the
# quantize pass: the mma.sync product and the one-warp-a-row pass they
# replaced (csrc/earlier/), kernel_variants.py's "earlier" rows, host
# launches (through a lighter call than the wrappers: at the TP shapes
# the host's work is most of the time), mean of the two readings, on the
# same card (PERF.md section 6): W8A8 bf16 results at the b64 cell's
# shapes (T=448) and the TP shapes; int32 at the TP shapes and the cell's.
EARLIER_MS = {
    "attention": {(64, 8, 448, 448, True, 64): 0.1661, (64, 8, 448, 370, True, 64): 0.1532,
                  (64, 4, 320, 320, True, 64): 0.0571, (64, 4, 320, 50, False, 64): 0.0331,
                  (1, 8, 448, 448, True, 64): 0.0525, (1, 8, 448, 370, True, 64): 0.0426,
                  (1, 4, 320, 320, True, 64): 0.0293, (1, 4, 320, 50, False, 64): 0.0614},
    "adaln_ffn": {(64, 448, 512, 2048): 0.4592, (1, 448, 512, 2048): 0.0567},
    "resblock_chain": {(64, 28672, 128): 4.970, (64, 3584, 256): 2.576,
                       (1, 896, 256): 0.0567, (1, 7168, 128): 0.0402},
    "int8_matmul": {(1792, 256, 512): 0.0211, (1792, 1024, 512): 0.0157,
                    (28672, 512, 512): 0.0505, (28672, 512, 2048): 0.1581,
                    (28672, 2048, 512): 0.1176, (23680, 512, 512): 0.0447},
    "w8a8_matmul": {(28672, 512, 512): 0.0420, (28672, 512, 2048): 0.1463,
                    (28672, 2048, 512): 0.1072, (23680, 512, 512): 0.0363,
                    (1792, 256, 512): 0.0182, (1792, 1024, 512): 0.0249},
    "quantize": {(28672, 512): 0.0218, (28672, 2048): 0.0671, (23680, 512): 0.0196,
                 (1792, 256): 0.0286, (1792, 512): 0.0230, (1792, 1024): 0.0172},
    # the one-warp-a-row LayerNorm (csrc/earlier/ln_modulate_warp_rows.cu):
    # its phase 5 times at the cell's shapes, host launches (PERF.md section 6)
    "ln_modulate": {(64, 448, 512, True): 0.0540, (64, 320, 256, False): 0.0300},
    "bias_rope": {}, "gated_residual": {},  # no earlier design
    # the W8A8 rope form's replaced design (its angles from device memory in
    # the epilogue, csrc/earlier/linear_rope_l2.cu) at the int8 cell's
    # shapes: kernel_variants.py w8a8_forms' "earlier" rows, host launches,
    # mean of the two readings (PERF.md section 6)
    "w8a8_matmul rope form": {(28672, 512, 512, "rope", 64): 0.0376,
                              (23680, 512, 512, "rope", 64): 0.0370},
    # the W8A8 residual form's replaced design (its gated residual by f32
    # operations a value, csrc/earlier/linear_resid_f32_epilogue.cu):
    # kernel_variants.py w8a8_forms' "earlier" rows, host launches, mean of
    # the two readings (PERF.md section 6)
    "w8a8_matmul residual form": {(28672, 512, 512, "residual", 448): 0.0449,
                                  (28672, 2048, 512, "residual", 448): 0.0768},
    "linear residual form": {},  # its rows are the linear kernel's, with theirs
    "w8a8_matmul silu-quantize form": {}, "ln_modulate quantize form": {},  # new forms
    # the replaced linear kernel (csrc/earlier/linear_pr17.cu): its phase 5 times
    # at the cell's shapes, host launches (PERF.md section 6); the rope form's
    # replaced design (csrc/earlier/linear_rope_l2.cu): kernel_variants.py
    # linear's "earlier" rows, host launches, mean of the two readings
    "linear": {(28672, 512, 512, "bias", 0): 0.0443, (64, 512, 4608, "bias", 0): 0.0746,
               (20480, 256, 1024, "silu", 0): 0.0816, (28672, 512, 96, "tail", 448): 0.0902,
               (28672, 96, 512, "bias", 0): 0.0414, (23680, 512, 512, "bias", 0): 0.0415,
               (20480, 256, 256, "bias", 0): 0.0491, (3200, 256, 256, "bias", 0): 0.0776,
               (28672, 512, 512, "rope", 64): 0.0462, (23680, 512, 512, "rope", 64): 0.0395,
               (20480, 256, 256, "rope", 64): 0.0349,
               # the residual form's replaced design (its gated residual and
               # bias add by f32 operations a value): kernel_variants.py
               # linear's "earlier" rows, host launches, mean of the readings
               (28672, 512, 512, "residual", 448): 0.0521,
               (20480, 256, 256, "residual", 0): 0.0478,
               (20480, 1024, 256, "residual", 0): 0.0421},
    # the conv kernel's one-tile-a-block design (csrc/earlier/
    # conv1d_tile_per_block.cu): its phase 5 times at the cell's shapes,
    # host launches (PERF.md section 6); at the pre_res pairs it ran
    # conv a without silu out and conv b with silu in (the earlier call
    # order of _resblock)
    "conv1d": {(64, 320, 256, 256, 5, 1, "silu_out+row_mask+residual"): 0.0663,
               (64, 448, 96, 512, 7, 1, "mask"): 0.0940,
               (64, 448, 512, 512, 3, 1, "silu_in+silu_out+mask"): 0.1687,
               (64, 448, 512, 512, 3, 3, "silu_in+silu_out+mask"): 0.1942,
               (64, 448, 512, 512, 3, 9, "silu_in+silu_out+mask"): 0.1822,
               (64, 448, 512, 512, 3, 1, "mask+residual"): 0.1793,
               (64, 448, 512, 2048, 5, 1, "silu_in+mask+fold8"): 0.7084,
               (64, 3584, 256, 1024, 5, 1, "silu_in+mask+fold8"): 1.5594,
               (64, 28672, 128, 32, 3, 1, "silu_in+tanh"): 0.8004},
}
DEV = torch.device("cuda")
CELL_ROWS = 64 * 640  # rows of a b64 batch at its T=640 bucket
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "supertonic_tpu_torch", "build", "smoke")


_PHASE = [time.perf_counter()]  # when the last phase began


def log(msg: str) -> None:
    """Print msg; a phase's heading also prints the seconds the last phase took."""
    if msg.startswith("phase "):
        now = time.perf_counter()
        print(f"  (the last phase took {now - _PHASE[0]:.1f}s)", flush=True)
        _PHASE[0] = now
    print(msg, flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn over reps launches (CUDA events, warmed)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one call of fn, from a CUDA graph of reps calls
    replayed (CUDA events around the replays), as the engine runs the
    kernels: no host work per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 5) / reps


def compare(name: str, got, ref, dtype) -> float:
    """allclose-style check at the dtype's tolerance; returns max abs err."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    tol = TOL[dtype]
    err = (got - ref).abs()
    worst = float((err / (tol + tol * ref.abs())).max())
    max_err = float(err.max())
    log(f"  {name}: max_abs_err={max_err:.3e} tol={tol:g} (atol=rtol) "
        f"worst/limit={worst:.3f}")
    if worst > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def bound(nbytes: float, nops: float, ops_dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, nops / PEAK_OPS[ops_dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 5: kernels against their plain versions
# ---------------------------------------------------------------------------

def measure(results, kernel, name, dtype, n_cell, err, fn, plain, nbytes, nops,
            lib=None, reps=10, shape=None, ops_dtype=None, line=True):
    """Time kernel, plain version and library call; log and keep one row.
    n_cell = launches at this shape per b64/5-step batch (0: not the cell's);
    shape = the cell's shape key, under which the earlier time is looked up;
    ops_dtype = the type whose peak rate bounds the operations (dtype's);
    line = whether the row may stand for the kernel in the kernels line (its
    library call computes the row's function)."""
    ms = time_ms(fn, reps)
    plain_ms = time_ms(plain, reps)
    lib_ms = None if lib is None else time_ms(lib, reps)
    bnd, by = bound(nbytes, nops, ops_dtype or dtype)
    lib_txt = "None" if lib_ms is None else f"{lib_ms:.4f}"
    earlier = EARLIER_MS[kernel].get(shape) if dtype != torch.float32 else None
    earlier_txt = "" if earlier is None else f" (earlier: {earlier} ms)"
    # each kernel in its path's type also from a replayed graph, beside the library call
    replay_txt, replay, lib_replay = "", None, None
    if dtype != torch.float32:
        replay = graph_ms(fn)
        replay_txt = f" graph_replay_ms={replay:.4f}"
        if lib is not None:
            lib_replay = graph_ms(lib)
            replay_txt += f" library_graph_replay_ms={lib_replay:.4f}"
    log(f"  {kernel} {name} {dtype}: kernel_ms={ms:.4f}{earlier_txt} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_txt} bound_ms={bnd:.4f} ({by}) cell_launches={n_cell}{replay_txt}")
    results[kernel].append(dict(name=name, dtype=dtype, n_cell=n_cell, max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bnd, bound_by=by, earlier_ms=earlier,
                                graph_ms=replay, library_graph_ms=lib_replay, line=line))


def check_attention(gen, cell, results, serving, widths):
    cases = [  # name, B, H, Tq, Tk, mask kind, launches per cell batch (None:
        #        checked, not timed), Dh
        ("ve_self T256", 64, 8, 256, 256, "tail", 0, 64),
        ("ve_cross Tk242", 64, 8, 256, 242, "tail", 0, 64),
        ("te_self L192", 64, 4, 192, 192, "tail", 0, 64),
        ("te_cross_nomask", 64, 4, 192, 50, None, 0, 64),
        ("fully_masked_row", 4, 8, 64, 96, "one_row_empty", None, 64),
        ("long_1100", 2, 8, 1100, 1100, "tail", 0, 64),
        # the bf16 kernel's tile edges: 64 queries a consumer warpgroup (128
        # with two), 64 keys a ring stage, wgmma's N in steps of 8 keys
        ("edge Tq65 Tk63", 3, 2, 65, 63, "tail", None, 64),
        ("edge Tq65 Tk63 no mask", 3, 2, 65, 63, None, None, 64),
        ("edge Tq63 Tk65", 3, 2, 63, 65, "tail", None, 64),
        ("edge Tq64 Tk64 no mask", 2, 2, 64, 64, None, None, 64),
        ("edge Tq129 Tk127", 2, 2, 129, 127, "tail", None, 64),
        ("edge Tk5, below one wgmma N step", 3, 2, 70, 5, "tail", None, 64),
        ("edge Tk100 no mask: the second stage's zero-filled keys", 3, 2, 129, 100, None, None,
         64),
        ("edge fully masked row, Tk70 crossing a stage", 2, 2, 65, 70, "one_row_empty", None,
         64),
        ("edge Tq1 Tk1", 2, 2, 1, 1, None, None, 64),
        ("edge Tq1 Tk1 masked", 2, 2, 1, 1, "tail", None, 64),
        ("edge B1 H1", 1, 1, 640, 640, "tail", None, 64),
        # the whole-row form's edges (bf16 Dh 64; each consumer warpgroup 32
        # ceil(Tk / 64) keys): its cap on Tk and one past it (the two-pass
        # kernel), a warpgroup's key range all padding (Tk 32: the second's
        # keys 32 .. 63) or all masked (row 0's keys past the first range, or
        # below it), a fully masked row crossing the warpgroups' split, or
        # within the first's range
        *((f"edge rows Tk{tk}", 3, 2, 129, tk, mk, None, 64)
          for tk in (attention.ROW_KEYS - 1, attention.ROW_KEYS, attention.ROW_KEYS + 1)
          for mk in ("tail", None)),
        ("edge rows Tk32: the second warpgroup's keys all padding", 3, 2, 129, 32, None, None,
         64),
        ("edge rows Tk448: the second warpgroup's keys all masked", 3, 2, 129, 448,
         "second_masked", None, 64),
        ("edge rows Tk448: the first warpgroup's keys all masked", 3, 2, 129, 448,
         "first_masked", None, 64),
        ("edge rows fully masked row crossing the split, Tk300", 2, 2, 129, 300,
         "one_row_empty", None, 64),
        ("edge rows fully masked row, Tk30: its keys in one warpgroup's range", 2, 2, 129, 30,
         "one_row_empty", None, 64),
    ]
    # the other head widths: every bf16 instance (16 .. 128 in steps of 16;
    # two 64-column panels above 64) and a width the bf16 wrapper pads (12,
    # 24, 100), at the tile edges; f32 takes each width as it is
    cases += [(f"edge Dh{dh} Tq65 Tk{tk}", 3, 2, 65, tk, mk, None, dh)
              for dh in (12, 16, 24, 32, 48, 80, 96, 100, 112, 128)
              for tk, mk in ((63, "tail"), (130, None))]
    cases += [("edge Dh128 fully masked row", 2, 2, 65, 70, "one_row_empty", None, 128)]
    # past 128: the bf16 kernel's three- and four-panel instances (144 .. 256)
    # and past 256 the SIMT kernel's slices of the output columns (f32 at
    # every width); timed at the TE's b64 shape for Dh 192 and 256 (a
    # tts.json with proj_out.idim 768 or 1024)
    cases += [(f"edge Dh{dh} Tq65 Tk{tk}", 3, 2, 65, tk, mk, None, dh)
              for dh in (144, 192, 256, 320)
              for tk, mk in ((63, "tail"), (130, None))]
    cases += [(f"edge Dh{dh} fully masked row", 2, 2, 65, 70, "one_row_empty", None, dh)
              for dh in (256, 320)]
    cases += [(f"wide Dh{dh} TE self B64 H4 L320", 64, 4, 320, 320, "tail", 0, dh)
              for dh in (192, 256)]
    cases += [(f"cell H{h} Tq{tq} Tk{tk}", b, h, tq, tk, "tail" if masked else None, n, dh)
              for (b, h, tq, tk, masked, dh), n in sorted(cell["attention"].items())]
    # the serving run's shapes, timed where a streamed chunk launches them
    cases += [(f"phase 7/11 H{h} Tq{tq} Tk{tk} ({k} per streamed chunk)", b, h, tq, tk,
               "tail" if masked else None, 0 if k else None, dh)
              for (b, h, tq, tk, masked, dh), k in sorted(serving["attention"].items())
              if (b, h, tq, tk, masked, dh) not in cell["attention"]]
    # phase 12's widths, off the b64 path: timed
    cases += [(f"phase 12 Dh{dh} H{h} Tq{tq} Tk{tk}", b, h, tq, tk,
               "tail" if masked else None, 0, dh)
              for (b, h, tq, tk, masked, dh) in sorted(widths["attention"])]
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, tq, tk, mk, n, dh in cases:
            q, k, v = (torch.randn((b, t, h, dh), generator=gen, device=DEV).to(dtype)
                       for t in (tq, tk, tk))
            mask = None
            if mk is not None:
                lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen, device=DEV)
                mask = (torch.arange(tk, device=DEV)[None] < lens[:, None]).float()
                if mk == "one_row_empty":
                    mask[0] = 0.0
                # row 0's keys valid in one consumer warpgroup's range of the
                # whole-row form alone (the first: keys 0 .. 32 ceil(Tk / 64) - 1)
                split = 32 * -(-tk // 64)
                if mk == "second_masked":
                    mask[0] = (torch.arange(tk, device=DEV) < split).float()
                if mk == "first_masked":
                    mask[0] = (torch.arange(tk, device=DEV) >= split).float()
            got = attention.fused_attention(q, k, v, mask)
            ref = attention.attention_plain(q, k, v, mask)
            err = compare(f"attention {name} B{b} {dtype}", got, ref, dtype)
            if mk == "one_row_empty":
                mean_v = v[0].float().mean(0, keepdim=True).expand(tq, h, dh)
                if not torch.allclose(got[0].float(), mean_v, atol=TOL[dtype] * 4,
                                      rtol=TOL[dtype]):
                    raise AssertionError("fully masked row is not the mean of v")
            if n is None:
                continue
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bias = None if mask is None else (
                (1.0 - mask) * -1e9)[:, None, None, :].to(dtype)
            es = q.element_size()
            nbytes = es * b * h * dh * (2 * tq + 2 * tk) + (0 if mask is None else 4 * b * tk)
            measure(results, "attention", name, dtype, n, err,
                    lambda: attention.fused_attention(q, k, v, mask),
                    lambda: attention.attention_plain(q, k, v, mask),
                    nbytes, 4.0 * b * h * tq * tk * dh,
                    lib=lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=bias), shape=(b, h, tq, tk, mk is not None, dh))


def check_ffn(gen, cell, results, serving, widths):
    """Each case: name, B, T, D, F, launches per cell batch (None: checked,
    not timed). The edges leave the bf16 GEMMs' row tiles ragged (B*T not a
    multiple of 128 or 64, or below one tile), make one tile read the gates
    of several batch rows (T not dividing the tile), take the many-row and
    the few-row tiles, leave GEMM1's 256-column tiles ragged (F 1152) and
    the LayerNorm pass's chunks uneven across a warp's lanes (D 384); the
    other widths leave K and N tails to TMA's zero fill and the stores' clip
    (D, F multiples of 8, not of 64) and the f32 tiles ragged."""
    cases = [("rows 64x256", 64, 256, 512, 2048, 0),
             ("edge B3 x T37", 3, 37, 512, 2048, None),
             ("edge B1 x T1", 1, 1, 512, 2048, None),
             ("edge B2 x T21: 42 rows, below one 64-row tile", 2, 21, 512, 2048, None),
             ("edge B5 x T100: few-row tiles straddle batch rows", 5, 100, 512, 2048, None),
             ("edge B64 x T37: many-row tiles straddle batch rows", 64, 37, 512, 2048, None),
             ("edge B2 x T200, D384 F1152", 2, 200, 384, 1152, None),
             ("edge B3 x T50, D200 F808: K and N tails", 3, 50, 200, 808, None),
             ("edge B64 x T37, D200 F808: many-row tiles with tails", 64, 37, 200, 808, None),
             ("edge B1 x T7, D8 F24: below one box", 1, 7, 8, 24, None),
             ("edge B2 x T37, D64 F256", 2, 37, 64, 256, None),
             ("edge B2 x T21, D1024 F1032: the widest bf16 row", 2, 21, 1024, 1032, None)]
    cases += [(f"cell rows {b}x{t}", b, t, d, f, n)
              for (b, t, d, f), n in sorted(cell["adaln_ffn"].items())]
    cases += [(f"phase 7/11 rows {b}x{t} ({k} per streamed chunk)", b, t, d, f,
               0 if k else None)
              for (b, t, d, f), k in sorted(serving["adaln_ffn"].items())
              if (b, t, d, f) not in cell["adaln_ffn"]]
    cases += [(f"phase 12 rows {b}x{t} D{d} F{f}", b, t, d, f, 0)
              for (b, t, d, f) in sorted(widths["adaln_ffn"])]
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, t, d, f, n in cases:
            x = torch.randn((b, t, d), generator=gen, device=DEV).to(dtype)
            g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=DEV)
            bl = 0.1 * torch.randn(d, generator=gen, device=DEV)
            w1 = (torch.rand((f, d), generator=gen, device=DEV) * 2 - 1).div(d ** 0.5).to(dtype)
            w2 = (torch.rand((d, f), generator=gen, device=DEV) * 2 - 1).div(f ** 0.5).to(dtype)
            b1 = 0.1 * torch.randn(f, generator=gen, device=DEV)
            b2 = 0.1 * torch.randn(d, generator=gen, device=DEV)
            shift, scale, gate = ((0.5 * torch.randn((b, 1, d), generator=gen, device=DEV))
                                  .to(dtype) for _ in range(3))
            args = (x, g, bl, w1, b1, w2, b2, shift, scale, gate)
            got = ffn.fused_adaln_ffn(*args)
            ref = ffn.adaln_ffn_plain(*args)
            err = compare(f"adaln_ffn {name} {dtype}", got, ref, dtype)
            if dtype == torch.bfloat16 and name.startswith("edge B3"):
                # the modulation vectors in f32 beside bf16 x (the kernel's other form)
                args32 = args[:7] + tuple(m.float() for m in args[7:])
                compare(f"adaln_ffn {name}, f32 modulation {dtype}",
                        ffn.fused_adaln_ffn(*args32), ffn.adaln_ffn_plain(*args32), dtype)
            if n is None:
                continue
            if dtype == torch.bfloat16:  # a yardstick; the FFN has no one call
                hb = torch.randn((b * t, d), generator=gen, device=DEV).to(dtype)
                b1b, b2b = b1.to(dtype), b2.to(dtype)
                pair = time_ms(lambda: torch.nn.functional.linear(
                    torch.nn.functional.silu(torch.nn.functional.linear(hb, w1, b1b)), w2, b2b),
                    5)
                log(f"  adaln_ffn {name}: the cuBLAS pair F.linear -> silu -> F.linear on "
                    f"the FFN's products takes {pair:.4f} ms (no LayerNorm, modulation or "
                    f"residual; a yardstick, not library_ms)")
            es = x.element_size()
            nbytes = es * (2 * b * t * d + 2 * d * f + 3 * b * d) + 4 * (3 * d + f)
            measure(results, "adaln_ffn", name, dtype, n, err,
                    lambda: ffn.fused_adaln_ffn(*args), lambda: ffn.adaln_ffn_plain(*args),
                    nbytes, 4.0 * b * t * d * f, reps=5, shape=(b, t, d, f))


def check_chain(gen, cell, results, serving, widths):
    """Each case: name, B, T', C, launches per cell batch (None: checked, not
    timed), frame mask ("tail": the last tenth masked, "zero": all masked),
    dilations, conv size. The tile edges at every instance of the kernel
    (vocoder_fused.CHAIN_WIDTHS) and at channel counts the wrapper pads to
    the next; chains the wrapper runs as several launches; pairs past the
    fused kernels' reach (per-conv launches), also where no fused bf16 tile
    holds the pair at C 320 and where none holds it at C 64 (dilation 150);
    phase 12's widths with their config's dilations and conv size."""
    dils = (1, 3, 9)
    cases = [("T'=8x256", 64, 8 * 256, 256, 0, "tail", dils, 3),
             ("T'=64x256", 64, 64 * 256, 128, 0, "tail", dils, 3)]
    cases += [(f"cell T'={t_len}", b, t_len, c, n, "tail", dils, 3)
              for (b, t_len, c), n in sorted(cell["resblock_chain"].items())]
    cases += [(f"phase 7/11 T'={t_len} ({k} per streamed chunk)", b, t_len, c,
               0 if k else None, "tail", dils, 3)
              for (b, t_len, c), k in sorted(serving["resblock_chain"].items())
              if (b, t_len, c) not in cell["resblock_chain"]]
    cases += [(f"phase 12 T'={t_len} dilations {d}", b, t_len, c, 0, "tail", d, ks)
              for (b, t_len, c), kinds in sorted(widths["resblock_chain"].items())
              for d, ks in sorted(kinds)]
    for dtype in (torch.float32, torch.bfloat16):
        # the wrapper's domain constant is the library's
        reach = vocoder_fused.max_pair_reach(dtype)
        if reach != vocoder_fused.MAX_PAIR_REACH[dtype]:
            raise AssertionError(f"chain pair reach {dtype}: library {reach}, "
                                 f"vocoder_fused.MAX_PAIR_REACH {vocoder_fused.MAX_PAIR_REACH}")
        edges = []  # the kernel's own tile width at each C and dtype
        for c in (128, 256):
            tile = vocoder_fused.chain_tile(c, dtype, dils)
            edges += [(f"edge T'={tile // 2 + 1} < tile {tile}", 3, tile // 2 + 1, c, None, "tail",
                       dils, 3),
                      (f"edge T'=tile+1={tile + 1}", 3, tile + 1, c, None, "tail", dils, 3),
                      (f"edge T'={2 * tile + 5}, all frames masked", 2, 2 * tile + 5, c, None,
                       "zero", dils, 3)]
        for c in (16, 32, 64, 96, 192, 200, 320, 384):
            tile = vocoder_fused.chain_tile(c, dtype, dils)
            edges += [(f"edge C={c} T'=2 tiles+3", 2, 2 * tile + 3, c, None, "tail", dils, 3),
                      (f"edge C={c} T'={tile // 2 + 1}, dilations (1, 3)", 3, tile // 2 + 1, c,
                       None, "tail", (1, 3), 3)]
        # off the default kernel and dilations: conv size 5, five pairs, a
        # dilation of 27, and a lone pair at the largest reach (dilation
        # reach - 1 at k 3, reach / 3 - 1 at k 7)
        top = vocoder_fused.MAX_PAIR_REACH[dtype]
        for c in (64, 128, 384):
            edges += [(f"k=5 C={c}", 2, 700, c, None, "tail", (1, 3), 5),
                      (f"five pairs C={c}", 2, 700, c, None, "tail", (1, 3, 9, 1, 3), 3),
                      (f"lone pair at reach {top} C={c}", 2, 300, c, None, "tail", (top - 1,), 3),
                      (f"k=7 C={c}", 2, 300, c, None, "tail", (1, top // 3 - 1), 7)]
            edges.append((f"dilations (1, 3, 9, 27) C={c}", 2, 700, c, None, "tail",
                          (1, 3, 9, 27), 3))
            # past the fused kernels' reach: k 3 at dilation 32 (33 frames, past
            # bf16's 31), k 11 at dilation 5 (30, past f32's 23), alone and in chains
            edges += [(f"past the reach: dilation 32 C={c}", 2, 300, c, None, "tail", (32,), 3),
                      (f"past the reach: dilations (1, 32, 3) C={c}", 2, 300, c, None, "tail",
                       (1, 32, 3), 3),
                      (f"past the reach: k=11 dilation 5 C={c}", 2, 300, c, None, "tail",
                       (5,), 11),
                      (f"past the reach: k=11 dilations (1, 3, 5) C={c}", 2, 300, c, None,
                       "tail", (1, 3, 5), 11)]
        edges += [("past the reach: dilation 32 C=320", 2, 300, 320, None, "tail", (32,), 3),
                  ("past every tile: dilation 150 C=64", 2, 400, 64, None, "tail", (150,), 3)]
        for name, b, t_len, c, n, mk, pair_dils, ks in cases + edges:
            if not vocoder_fused.supports(c, ks, pair_dils, dtype):
                raise AssertionError(f"chain case {name} {dtype} lies outside supports()")
            x = torch.randn((b, t_len, c), generator=gen, device=DEV).to(dtype)
            fm = torch.zeros(t_len, device=DEV)
            if mk == "tail":
                fm[:t_len - max(1, t_len // 10)] = 1.0
            s = (ks * c) ** -0.5
            p = len(pair_dils)
            wa, wb = ((torch.rand((p, ks, c, c), generator=gen, device=DEV) * 2 - 1)
                      .mul(s).to(dtype) for _ in range(2))
            ba, bb = (0.1 * torch.randn((p, c), generator=gen, device=DEV) for _ in range(2))
            args = (x, fm, wa, ba, wb, bb, pair_dils)
            got = vocoder_fused.resblock_chain(*args)
            ref = vocoder_fused.resblock_chain_plain(*args)
            width = vocoder_fused.kernel_width(c)
            plan = vocoder_fused.launch_plan(width, ks, tuple(pair_dils), dtype)
            where = []
            for i, j, route in plan:
                if route == "conv":
                    where.append("per-conv x2")
                    continue
                tile = vocoder_fused._tile(width, ks, pair_dils[i:j], dtype, b, t_len)
                where.append(f"{'wgmma' if dtype == torch.bfloat16 else 'simt'} "
                             f"{-(-t_len // tile)} tiles of {tile}")
            where = " + ".join(where)
            err = compare(f"resblock_chain C={c} B{b} {name} k={ks} launches: {where} "
                          f"{dtype}", got, ref, dtype)
            if not torch.equal(got[:, -1], x[:, -1]):
                raise AssertionError("masked tail frame changed")
            if mk == "zero" and not torch.equal(got, x):
                raise AssertionError("a chain with every frame masked changed x")
            if n is None:
                continue
            es = x.element_size()
            nbytes = es * (2 * b * t_len * c + 2 * p * ks * c * c) + 4 * (t_len + 2 * p * c)
            measure(results, "resblock_chain", f"C={c} {name}", dtype, n, err,
                    lambda: vocoder_fused.resblock_chain(*args),
                    lambda: vocoder_fused.resblock_chain_plain(*args),
                    nbytes, 4.0 * ks * p * c * c * b * t_len, reps=3, shape=(b, t_len, c))


def check_int8_matmul(gen, cell, results, tp):
    """Exact (max abs error 0) against the plain version, float64 sums cast
    to int32, at its path's shapes (the row-parallel W8A8 linears of phase
    11's TP int8 batch, ``tp``: (M, K, N) -> launches), at the W8A8 path's
    and at edge shapes; timed at its path's shapes (with their launches),
    at the W8A8 path's and at the edge shapes with M = 40,960."""
    cases = {(m, k, n): 0 for m in (1, 37, CELL_ROWS) for k in (32, 512, 2048)
             for n in (24, 512, 1536, 2048)}
    cases.update({shape: 0 for shape in ODD_N})
    w8a8_products = {key[:3] for key in cell["w8a8_matmul"]}  # (M, K, N) of every form
    cases.update(dict.fromkeys(w8a8_products, 0))
    cases.update(tp)
    for (m, k, n), n_cell in sorted(cases.items()):
        a, w = (torch.randint(-127, 128, shape, generator=gen, device=DEV).to(torch.int8)
                for shape in ((m, k), (n, k)))
        a[0], w[0] = 127, 127  # the largest sum, 127^2 * K
        got = int8_matmul.int8_matmul(a, w)
        ref = int8_matmul.int8_matmul_plain(a, w)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        log(f"  int8_matmul M{m} K{k} N{n}: max_abs_err={err} (exact required)")
        if got.dtype != torch.int32 or err != 0:
            raise AssertionError("int8_matmul disagrees with its plain version")
        if not n_cell and m < CELL_ROWS and (m, k, n) not in w8a8_products:
            continue
        lib = None
        if m <= 16 or k % 8 or n % 8:
            log(f"  torch._int_mm refuses M{m} K{k} N{n} (it takes M > 16, K and N "
                f"multiples of 8): library_ms None")
        else:  # cuBLASLt's int8 product, the yardstick; the port never calls it
            lib = lambda: torch._int_mm(a, w.t())
        measure(results, "int8_matmul", f"M{m} K{k} N{n}", torch.int8, n_cell, err,
                lambda: int8_matmul.int8_matmul(a, w),
                lambda: int8_matmul.int8_matmul_plain(a, w),
                m * k + n * k + 4 * m * n, 2.0 * m * n * k, lib=lib, shape=(m, k, n))


def check_quantize(gen, cell, results, serving):
    """xq and sx bit-equal to the plain version's, from f32 and bf16 x, at
    the cell's shapes, the int8 server's and edge shapes, each with a zero
    row (the 1e-12 clamp) and a row of x.5 values (half to even), K up to
    2048 (a warp's slot) and past it, and K 24; timed in bf16, the path's
    type, at the cell's shapes and at the edge shapes with M = 40,960."""
    cases = {(m, k): 0 for m in (1, 37, CELL_ROWS) for k in (32, 512, 2048)}
    cases[(37, 4104)] = 0  # rows past 4 KB (bf16) go through a ring twice
    cases[(37, 24)] = 0  # K an odd multiple of 8: 8-byte stores of xq
    cases.update(cell["quantize"])  # (M, K): launches per cell batch
    for key in serving["quantize"]:
        cases.setdefault(key, None)  # checked, not timed
    halves = torch.tensor(HALVES, device=DEV)
    for (m, k), n_cell in sorted(cases.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn((m, k), generator=gen, device=DEV)).to(dtype)
            x[0] = 0.0
            if m > 1:
                x[1, :len(HALVES)] = halves.to(dtype)
            xq, sx = quantize.quantize_rows(x)
            rq, rs = quantize.quantize_rows_plain(x)
            torch.cuda.synchronize()
            ok = torch.equal(xq, rq) and torch.equal(sx.view(torch.int32), rs.view(torch.int32))
            log(f"  quantize M{m} K{k} {dtype}: xq and sx bit-equal {ok}")
            if not ok:
                raise AssertionError("quantize disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and m < CELL_ROWS:
                continue
            measure(results, "quantize", f"M{m} K{k}", dtype, n_cell, 0.0,
                    lambda: quantize.quantize_rows(x), lambda: quantize.quantize_rows_plain(x),
                    m * k * (x.element_size() + 1) + 4 * m, 3.0 * m * k, shape=(m, k),
                    ops_dtype=torch.float32)


def check_w8a8(gen, cell, results, serving):
    """The int8 product with its rescale-and-bias epilogue bit-equal to the
    plain version (exact product, f32 rescale, one rounding), bf16 and f32
    out, and its silu form bit-equal to F.silu of its own output, at the
    cell's shapes, the int8 server's and edge shapes; the
    operands come from the
    quantize pass of a random x with a zero row, plus one row and one weight
    row at 127 (the largest sum, 127^2 K, rounds when made float). Timed in
    bf16, the path's type, at the cell's shapes and at the edge shapes with
    M = 40,960."""
    cases = {(m, k, n): 0 for m in (1, 37, CELL_ROWS) for k in (32, 512, 2048)
             for n in (24, 512, 2048)}
    cases.update({shape: 0 for shape in ODD_N})
    # (M, K, N): launches per cell batch of the bias and silu forms (the rope
    # and residual forms' keys are check_w8a8_forms')
    cases.update({key: n for key, n in cell["w8a8_matmul"].items() if len(key) == 3})
    for key in serving["w8a8_matmul"]:
        if len(key) == 3:
            cases.setdefault(key, None)  # checked, not timed
    for (m, k, n), n_cell in sorted(cases.items()):
        x = torch.randn((m, k), generator=gen, device=DEV)
        x[0] = 0.0
        xq, sx = quantize.quantize_rows_plain(x)
        xq[-1] = 127
        w = torch.randint(-127, 128, (n, k), generator=gen, device=DEV).to(torch.int8)
        w[0] = 127
        ws = torch.rand(n, generator=gen, device=DEV) * 0.01
        bias = 0.1 * torch.randn(n, generator=gen, device=DEV)
        args = (xq, sx, w, ws, bias)
        for dtype in (torch.float32, torch.bfloat16):
            got = w8a8.w8a8_matmul(*args, dtype)
            ref = w8a8.w8a8_matmul_plain(*args, dtype)
            silu = w8a8.w8a8_matmul(*args, dtype, silu=True)
            torch.cuda.synchronize()
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            err = float((got.float() - ref.float()).abs().max())
            ok = got.dtype == dtype and torch.equal(got.view(bits), ref.view(bits))
            # the silu form: F.silu of the kernel's own output, bit for bit
            silu_ok = silu.dtype == dtype and bits_equal(silu, torch.nn.functional.silu(got))
            log(f"  w8a8_matmul M{m} K{k} N{n} {dtype}: bit-equal {ok} (max abs err {err:g}); "
                f"silu form bit-equal to F.silu of it {silu_ok}")
            if not ok or not silu_ok:
                raise AssertionError("w8a8_matmul disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and m < CELL_ROWS:
                continue
            lib = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:  # the product alone: no epilogue
                lib = lambda: torch._int_mm(xq, w.t())
            log(f"  w8a8_matmul M{m} K{k} N{n}: library_ms is torch._int_mm, the int8 product "
                f"alone (int32 out, no rescale or bias)" if lib else
                f"  torch._int_mm refuses M{m} K{k} N{n}: library_ms None")
            measure(results, "w8a8_matmul", f"M{m} K{k} N{n}", dtype, n_cell, err,
                    lambda: w8a8.w8a8_matmul(*args, dtype),
                    lambda: w8a8.w8a8_matmul_plain(*args, dtype),
                    m * k + n * k + 4 * m + 8 * n + got.element_size() * m * n,
                    2.0 * m * n * k, lib=lib, shape=(m, k, n), ops_dtype=torch.int8)


def w8a8_form_inputs(gen, key):
    """The W8A8 operands (xq and sx from the quantize pass of a random x with
    a zero row, one row at 127; int8 weights with one row at 127; weight
    scales and a bias) and the form's options of a rope or residual shape
    key (M, K, N, form, Dh or the gate's rows a batch row), as
    linear_inputs makes them for the linear kernel."""
    m, k, n, form, t = key
    x = torch.randn((m, k), generator=gen, device=DEV)
    x[0] = 0.0
    xq, sx = quantize.quantize_rows_plain(x)
    xq[-1] = 127
    w = torch.randint(-127, 128, (n, k), generator=gen, device=DEV).to(torch.int8)
    w[0] = 127
    ws = torch.rand(n, generator=gen, device=DEV) * 0.01
    bias = 0.1 * torch.randn(n, generator=gen, device=DEV)
    if form == "rope":
        pos = torch.rand((1, m), generator=gen, device=DEV) * 100.0
        kw = {"rope": layers.rope_angles(pos, t, 10000.0), "n_heads": n // t}
    else:
        bsz, rows = (m // t, t) if t else (1, m)
        kw = {"residual": torch.randn((bsz, rows, n), generator=gen,
                                      device=DEV).to(torch.bfloat16),
              "gate": modulation(gen, bsz, n, torch.bfloat16)[2] if t else None}
    return (xq, sx, w, ws, bias), kw


def w8a8_form_exact(gen, key, args, kw, got, own) -> bool:
    """The W8A8 rope or residual form ``got`` bit for bit the plain rotation
    or gated residual of the product's own bias form ``own`` [M, N]; the
    residual form also with a gate of one row for all and with gate rows at
    an odd element (copied by the wrapper)."""
    m, k, n, form, t = key
    if form == "rope":
        cos, sin = kw["rope"]
        return bits_equal(got, rope.bias_rope_plain(own.view(*cos.shape[:2], n), None, cos,
                                                    sin, kw["n_heads"]))
    residual, gate = kw["residual"], kw["gate"]
    y = own.view(residual.shape)
    exact = bits_equal(got, gated_residual.gated_residual_plain(residual, y, None, gate))
    if gate is not None:
        one = modulation(gen, 1, n, torch.bfloat16, rows=1)[2]
        odd = torch.randn((gate.shape[0], 1, n + 1), generator=gen,
                          device=DEV).to(torch.bfloat16)[..., 1:]
        for g in (one, odd):
            out = w8a8.w8a8_matmul(*args, torch.bfloat16, residual=residual, gate=g)
            exact = exact and bits_equal(
                out, gated_residual.gated_residual_plain(residual, y, None, g))
    return exact


def check_w8a8_forms(gen, cell, results, serving, widths):
    """The W8A8 product's rope and residual forms (the int8 path's Q, K and
    O) bit for bit the product's own bias form (itself bit for bit the plain
    version) followed by the plain rotation or gated residual, at the int8
    cell's, the int8 server's streamed chunk's and phase 12's widths (the
    linear kernel's rope and residual shapes there, where K takes the int8
    product: a multiple of 32) and at edges: every instance (128 x 128 at
    Dh 16, 32, 64 and 128 and at ragged M, 64 x 64 at a streamed chunk's M,
    64 x 192 at Dh 96 and 192, 64 x 256, the SIMT kernel at Dh 12 and 36;
    the residual form's 64 x 128 tiles of three consumers, 64 x 64 tiles and
    register-stored 64 x 32 ones at N off 8, odd N; the 64 x 128 tiles also
    at M off the tile, N off 128 and gate rows of three batch rows in a
    tile), K 2,048, a gate of B
    rows (strided), of one row for all, of rows at an odd element, and none.
    Timed at the cell's and a chunk's shapes beside the pair each replaces
    (the W8A8 product, then the bias-and-rope or gated-residual kernel),
    host-launched and from a graph; library_ms None (no one PyTorch call
    computes a form)."""
    edges = [(300, 64, 32, "rope", 16), (300, 64, 64, "rope", 32),
             (17037, 512, 512, "rope", 64), (448, 512, 512, "rope", 64),
             (50, 256, 256, "rope", 64), (200, 384, 384, "rope", 96), (37, 384, 96, "rope", 96),
             (150, 512, 384, "rope", 192), (300, 256, 256, "rope", 128),
             (200, 1024, 1024, "rope", 256), (100, 64, 48, "rope", 12),
             (100, 96, 72, "rope", 36), (37, 96, 96, "residual", 37),
             (3 * 50, 256, 256, "residual", 50), (17037, 512, 512, "residual", 0),
             (300, 1024, 256, "residual", 0), (2 * 50, 64, 30, "residual", 50),
             (4 * 33, 32, 15, "residual", 33), (448, 512, 512, "residual", 448),
             (2 * 32, 2048, 512, "residual", 32), (448, 2048, 512, "residual", 448),
             # the many-tile residual instances at their edges, as check_linear
             (17037, 256, 256, "residual", 0), (17037, 512, 200, "residual", 0),
             (17050, 512, 512, "residual", 50), (17037, 2048, 512, "residual", 0),
             (17037, 2048, 200, "residual", 0), (17050, 2048, 512, "residual", 50),
             (17037, 1024, 256, "residual", 0)]
    cases = dict.fromkeys(edges, 0)
    cases.update({key: n for key, n in cell["w8a8_matmul"].items()
                  if len(key) == 5 and key[3] in ("rope", "residual")})
    for key in serving["w8a8_matmul"]:
        if len(key) == 5 and key[3] in ("rope", "residual"):
            cases.setdefault(key, 0)
    for key in widths["linear"]:
        if key[3] in ("rope", "residual") and key[1] % 32 == 0:
            cases.setdefault(key, 0)
    pairs = {"rope": [], "residual": []}  # (launches, form ms, pair ms, bound) from graphs
    bf16 = torch.bfloat16
    for key, n_cell in sorted(cases.items()):
        m, k, n, form, t = key
        args, kw = w8a8_form_inputs(gen, key)
        got = w8a8.w8a8_matmul(*args, bf16, **kw)
        own = w8a8.w8a8_matmul(*args, bf16)
        plain = w8a8.w8a8_matmul_plain(*args, bf16)
        exact = bits_equal(own, plain) and w8a8_form_exact(gen, key, args, kw, got, own)
        torch.cuda.synchronize()
        per_chunk = serving["w8a8_matmul"].get(key, 0)
        instance = w8a8.kernel_instance(m, k, n, form, t if form == "rope" else 0)
        what = (f"M{m} K{k} N{n} {form}{f' (T {t})' if t else ''}"
                f"{f' ({per_chunk} per streamed chunk)' if per_chunk else ''}")
        log(f"  w8a8_matmul {what} ({instance}): bias form bit-equal to the plain version and "
            f"the {form} form bit-equal to the plain "
            f"{'rotation' if form == 'rope' else 'gated residual'} of it: {exact}")
        if not exact or not torch.isfinite(got.float()).all():
            raise AssertionError(f"the W8A8 {form} form disagrees with its plain version")
        if not (n_cell or per_chunk or m >= CELL_ROWS // 2):
            continue
        nbytes = m * k + n * k + 4 * m + 8 * n + 2 * m * n
        if form == "rope":
            nbytes += 4 * m * t  # cos and sin, [M, Dh / 2] f32 each
        else:
            nbytes += 2 * m * n + (2 * (m // t) * n if t else 0)  # the residual, the gate
        name = f"w8a8_matmul {form} form"
        measure(results, name, what, bf16, n_cell, 0.0,
                lambda: w8a8.w8a8_matmul(*args, bf16, **kw),
                lambda: w8a8.w8a8_matmul_plain(*args, bf16, **kw), nbytes, 2.0 * m * n * k,
                shape=key, ops_dtype=torch.int8)

        def pair():  # the W8A8 product, then the bias-and-rope or gated-residual kernel
            y = w8a8.w8a8_matmul(*args, bf16)
            if form == "rope":
                cos, sin = kw["rope"]
                return rope.bias_rope(y.view(*cos.shape[:2], n), None, cos, sin, kw["n_heads"])
            return gated_residual.gated_residual(kw["residual"], y.view(kw["residual"].shape),
                                                 None, kw["gate"])
        pair_ms, pair_graph = time_ms(pair), graph_ms(pair)
        row = results[name][-1]
        row["pair_ms"] = pair_graph
        after = "bias_rope" if form == "rope" else "gated_residual"
        log(f"    the pair it replaces (w8a8_matmul, then {after}): {pair_ms:.4f} ms [graph "
            f"{pair_graph:.4f}]; the form {row['ms']:.4f} [graph {row['graph_ms']:.4f}], "
            f"bound {row['bound_ms']:.4f}")
        if n_cell:
            pairs[form].append((n_cell, row["graph_ms"], pair_graph, row["bound_ms"]))
    for form, rows in pairs.items():
        if rows:
            log(f"  w8a8_matmul {form} form per b64/5-step int8 batch at the cell's shapes "
                f"({sum(r[0] for r in rows)} launches), from graphs: "
                f"{sum(r[0] * r[1] for r in rows):.4f} ms, the pairs it replaces "
                f"{sum(r[0] * r[2] for r in rows):.4f} ms, bound "
                f"{sum(r[0] * r[3] for r in rows):.4f} ms")


def check_quantizing_forms(gen, cell, results, serving):
    """The int8 path's quantize pass inside its producers, each bit for bit
    the two-kernel pair it replaces on the card and held against its plain
    version on the same card tensors: the LayerNorm kernel's quantizing form
    (ln_modulate's rows, then quantize_rows; against the plain version
    through the rows' one-step rule: (xq, sx) bit for bit quantize_rows_plain
    of the kernel's rows, those rows within one step of the plain LayerNorm's
    (ln_modulate.one_step_match), and (xq, sx) the plain version's wherever
    the rows are) and the W8A8 product's silu-quantize form (its silu form,
    then quantize_rows; a thread-block cluster a row block; bit for bit its
    plain version), at the int8 cell's shapes, the int8
    server's streamed chunk's, phase 12's VE widths (D 384 and 192, the FFN
    in at N 1,536 and 768, K 384 and 192) and at edges: one row, rows off the
    tiles and the LayerNorm's runs, a batch stride of 0 (one row of
    modulation for all), no modulation, D 8 and 1,024 (the form's widths), a
    cluster of one block (N 128) and of 2 and 3, K 32, a zero row and a row at
    127 (its values reach past the silu table). Timed at
    the cell's and a chunk's shapes beside the pair and the bound,
    host-launched and from graphs; max_abs_err that of the dequantized
    values xq * sx against the plain version's; library_ms None (no one
    PyTorch call computes either form). First the silu-quantize form at
    every finite bf16 value (siluq_every_bf16)."""
    bf16 = torch.bfloat16
    pairs = {}  # form: [(launches, form ms, pair ms, bound ms)] from graphs
    siluq_every_bf16()

    def dequantized_err(q, sc, pq, ps) -> float:
        return float((q.float() * sc[:, None] - pq.float() * ps[:, None]).abs().max())

    def time_beside_pair(name, what, n_cell, err, fn, plain, pair, nbytes, nops, shape,
                         ops_dtype):
        measure(results, name, what, bf16, n_cell, err, fn, plain, nbytes, nops, shape=shape,
                ops_dtype=ops_dtype)
        row = results[name][-1]
        pair_ms, pair_graph = time_ms(pair), graph_ms(pair)
        log(f"    the pair it replaces: {pair_ms:.4f} ms [graph {pair_graph:.4f}]; the form "
            f"{row['ms']:.4f} [graph {row['graph_ms']:.4f}], bound {row['bound_ms']:.4f}")
        if n_cell:
            pairs.setdefault(name, []).append((n_cell, row["graph_ms"], pair_graph,
                                               row["bound_ms"]))

    ln_edges = [(1, 1, 8, True), (2, 3, 8, False), (3, 37, 200, True), (2, 21, 1024, True),
                (64, 37, 512, False), (5, 100, 512, True), (4, 448, 384, True),
                (4, 448, 192, True), (1, 448, 512, True)]
    cases = dict.fromkeys(ln_edges, 0)
    cases.update({key[:4]: n for key, n in cell["ln_modulate quantize form"].items()})
    for key in serving["ln_modulate"]:
        if len(key) == 5:
            cases.setdefault(key[:4], 0)
    for (b, t, d, modulated), n_cell in sorted(cases.items()):
        x = (2 * torch.randn((b, t, d), generator=gen, device=DEV) + 0.3).to(bf16)
        x[0, 0] = 0.0  # a constant row: the LayerNorm's bias (D 8: zero, the 1e-12 clamp)
        g = 1.0 + 0.2 * torch.randn(d, generator=gen, device=DEV)
        bl = torch.zeros(d, device=DEV) if d == 8 else 0.2 * torch.randn(d, generator=gen,
                                                                          device=DEV)
        mods = [modulation(gen, b, d, bf16)[:2]] if modulated else [(None, None)]
        if (b, t, d) == (3, 37, 200):
            mods.append(modulation(gen, b, d, bf16, rows=1)[:2])
        for shift, scale in mods:
            xq, sx = ln_modulate.ln_modulate_quantize(x, g, bl, shift, scale)
            got = ln_modulate.ln_modulate(x, g, bl, shift, scale)
            rows = got.reshape(-1, d)
            rq, rs = quantize.quantize_rows(rows)
            qq, qs = quantize.quantize_rows_plain(rows)
            pq, ps = ln_modulate.ln_modulate_quantize_plain(x, g, bl, shift, scale)
            prows = ln_modulate.ln_modulate_plain(x, g, bl, shift, scale).reshape(-1, d)
            torch.cuda.synchronize()
            ok = bits_equal(xq, rq) and bits_equal(sx, rs)
            matched = ln_modulate.one_step_match(got, x, g, bl, shift, scale)[1]
            same = (rows.view(torch.int16) == prows.view(torch.int16)).all(-1)
            plain_ok = (bits_equal(xq, qq) and bits_equal(sx, qs) and matched == 1.0
                        and bits_equal(xq[same], pq[same]) and bits_equal(sx[same], ps[same]))
            err = dequantized_err(xq, sx, pq, ps)
            one = shift is not None and shift.shape[0] == 1
            log(f"  ln_modulate quantize form B{b} x T{t} D{d} "
                f"{'modulated' if modulated else 'plain LN'}"
                f"{' (one row of modulation)' if one else ''}: (xq, sx) bit-equal to "
                f"ln_modulate then quantize_rows: {ok}; against the plain version: "
                f"quantize_rows_plain of its rows, those within one step ({matched:.6f}), "
                f"(xq, sx) the plain version's on the {int(same.sum())} of {b * t} rows "
                f"bit-equal to its: {plain_ok} (dequantized max abs err {err:.3e})")
            if not ok:
                raise AssertionError("the quantizing LayerNorm disagrees with its pair")
            if not plain_ok:
                raise AssertionError("the quantizing LayerNorm disagrees with its plain version")
        if not (n_cell or (b, t) == (1, 448)):
            continue
        shift, scale = mods[-1]
        rows = b * t
        time_beside_pair(
            "ln_modulate quantize form", f"B{b} x T{t} D{d}{' mod' if modulated else ''}",
            n_cell, err, lambda: ln_modulate.ln_modulate_quantize(x, g, bl, shift, scale),
            lambda: ln_modulate.ln_modulate_quantize_plain(x, g, bl, shift, scale),
            lambda: quantize.quantize_rows(
                ln_modulate.ln_modulate(x, g, bl, shift, scale).reshape(-1, d)),
            3 * rows * d + 4 * rows + 8 * d + (4 * b * d if modulated else 0),
            (14 if modulated else 11) * rows * d, (b, t, d, modulated, "quantize"),
            torch.float32)

    sq_edges = [(1, 512, 2048), (37, 32, 512), (300, 64, 256), (300, 64, 128), (100, 96, 384),
                (17037, 384, 1536), (1000, 192, 768), (448, 512, 2048)]
    cases = dict.fromkeys(sq_edges, 0)
    cases.update({key[:3]: n for key, n in cell["w8a8_matmul"].items()
                  if len(key) == 5 and key[3] == "silu_quantize"})
    for key in serving["w8a8_matmul"]:
        if len(key) == 5 and key[3] == "silu_quantize":
            cases.setdefault(key[:3], 0)
    for (m, k, n), n_cell in sorted(cases.items()):
        x = torch.randn((m, k), generator=gen, device=DEV)
        x[0] = 0.0
        xq, sx = quantize.quantize_rows_plain(x)
        xq[-1] = 127
        w = torch.randint(-127, 128, (n, k), generator=gen, device=DEV).to(torch.int8)
        w[0] = 127
        ws = torch.rand(n, generator=gen, device=DEV) * 0.01
        bias = 0.1 * torch.randn(n, generator=gen, device=DEV)
        args = (xq, sx, w, ws, bias, bf16)
        hq, hs = w8a8.w8a8_matmul(*args, silu=True, quantize=True)
        rq, rs = quantize.quantize_rows(w8a8.w8a8_matmul(*args, silu=True))
        pq, ps = w8a8.w8a8_matmul_plain(*args, silu=True, quantize=True)
        torch.cuda.synchronize()
        ok = bits_equal(hq, rq) and bits_equal(hs, rs)
        plain_ok = bits_equal(hq, pq) and bits_equal(hs, ps)
        err = dequantized_err(hq, hs, pq, ps)
        log(f"  w8a8_matmul silu-quantize form M{m} K{k} N{n} (a cluster of {n // w8a8.SQ_BN} "
            f"blocks): (hq, hs) bit-equal to the silu form then quantize_rows: {ok}; "
            f"to the plain version: {plain_ok} (dequantized max abs err {err:.3e})")
        if not ok:
            raise AssertionError("the W8A8 silu-quantize form disagrees with its pair")
        if not plain_ok:
            raise AssertionError("the W8A8 silu-quantize form disagrees with its plain version")
        if not (n_cell or m == 448):
            continue
        time_beside_pair(
            "w8a8_matmul silu-quantize form", f"M{m} K{k} N{n}", n_cell, err,
            lambda: w8a8.w8a8_matmul(*args, silu=True, quantize=True),
            lambda: w8a8.w8a8_matmul_plain(*args, silu=True, quantize=True),
            lambda: quantize.quantize_rows(w8a8.w8a8_matmul(*args, silu=True)),
            m * k + n * k + 8 * m + 8 * n + m * n, 2.0 * m * n * k, (m, k, n, "silu_quantize", 0),
            torch.int8)
    for name, rows in pairs.items():
        log(f"  {name} per b64/5-step int8 batch at the cell's shapes "
            f"({sum(r[0] for r in rows)} launches), from graphs: "
            f"{sum(r[0] * r[1] for r in rows):.4f} ms, the pairs it replaces "
            f"{sum(r[0] * r[2] for r in rows):.4f} ms, bound "
            f"{sum(r[0] * r[3] for r in rows):.4f} ms")


def block_cases(edges, cell, serving, widths, kernel):
    """{shape key: launches per cell batch (None: checked, not timed)} of one
    of the block's elementwise kernels: the edges, the cell's shapes, the
    serving and mesh shapes and phase 12's."""
    cases = dict.fromkeys(edges, 0)
    cases.update(cell[kernel])
    for key in serving[kernel]:
        cases.setdefault(key, None)
    for key in widths[kernel]:
        cases.setdefault(key, 0)
    return cases


def modulation(gen, b, d, dtype, rows=None):
    """shift, scale and gate as block takes them: [B, 1, D] slices of one
    AdaLN projection (strided views), or ``rows`` = 1: one row for all."""
    m = 0.5 * torch.randn((rows or b, 1, 3 * d), generator=gen, device=DEV)
    return m.to(dtype).chunk(3, dim=-1)


def bits_equal(got, want) -> bool:
    view = BITS.get(want.dtype, want.dtype)
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(view), want.view(view)))


def check_ln_modulate(gen, cell, results, serving, widths):
    """The LayerNorm with the AdaLN modulation against its plain version,
    with and without the modulation, at the cell's, the servers' and phase
    12's shapes and at edges: D below a warp's chunks, no multiple of 8
    (bf16: the scalar warp), past the register-held rows (D 1032, 4104),
    batch rows straddling the warps' runs, one row of modulation for all.
    f32 within ln_modulate.F32_ATOL; bf16 every element the plain version's
    affine and modulation of the normalized value at its bf16 rounding or
    one step beside it (ln_modulate.one_step_match; the share bit-equal
    printed). Timed in bf16 at the cell's shapes; library_ms is
    F.layer_norm (no modulation: no one call computes it with one)."""
    edges = [(1, 1, 8, True), (3, 37, 200, True), (2, 7, 36, True), (2, 21, 1032, True),
             (2, 5, 4104, False), (5, 100, 512, True), (64, 37, 512, False), (1, 448, 512, True)]
    cases = {key: n for key, n in block_cases(edges, cell, serving, widths,
                                              "ln_modulate").items()
             if len(key) == 4}  # (B, T, D, modulated, "quantize"): check_quantizing_forms
    for (b, t, d, modulated), n_cell in sorted(cases.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x = (2 * torch.randn((b, t, d), generator=gen, device=DEV) + 0.3).to(dtype)
            g = 1.0 + 0.2 * torch.randn(d, generator=gen, device=DEV)
            bl = 0.2 * torch.randn(d, generator=gen, device=DEV)
            mods = [(None, None)]
            if modulated:
                mods.append(modulation(gen, b, d, dtype)[:2])
                if (b, t, d) == (3, 37, 200):
                    mods.append(modulation(gen, b, d, dtype, rows=1)[:2])
            for shift, scale in mods[modulated:]:
                got = ln_modulate.ln_modulate(x, g, bl, shift, scale)
                ref = ln_modulate.ln_modulate_plain(x, g, bl, shift, scale)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                what = (f"ln_modulate B{b} x T{t} D{d} "
                        f"{'modulated' if shift is not None else 'plain LN'}"
                        f"{' (one row of modulation)' if shift is not None and shift.shape[0] == 1 else ''}"
                        f" {dtype}")
                if dtype == torch.float32:
                    ok = err <= ln_modulate.F32_ATOL
                    log(f"  {what}: max abs err {err:.3e} (<= {ln_modulate.F32_ATOL:g}) {ok}")
                else:
                    same, matched = ln_modulate.one_step_match(got, x, g, bl, shift, scale)
                    ok = matched == 1.0
                    log(f"  {what}: bit-equal share {same:.6f}, within one step of the "
                        f"normalized value {matched:.6f} (max abs err {err:.3e})")
                if not ok or not torch.isfinite(got.float()).all():
                    raise AssertionError("ln_modulate disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and b * t < CELL_ROWS // 2:
                continue
            shift, scale = mods[-1]
            es, rows = x.element_size(), b * t
            lib = (None if modulated else lambda: torch.nn.functional.layer_norm(
                x, (d,), g.to(dtype), bl.to(dtype)))
            measure(results, "ln_modulate", f"B{b} x T{t} D{d}{' mod' if modulated else ''}",
                    dtype, n_cell, err, lambda: ln_modulate.ln_modulate(x, g, bl, shift, scale),
                    lambda: ln_modulate.ln_modulate_plain(x, g, bl, shift, scale),
                    2 * es * rows * d + 8 * d + (2 * es * b * d if modulated else 0),
                    (11 if modulated else 8) * rows * d, lib=lib, shape=(b, t, d, modulated),
                    ops_dtype=torch.float32)


def check_rope(gen, cell, results, serving, widths):
    """The bias add with the rotary embedding bit-equal to its plain version,
    with and without the bias, at the cell's, the servers' and phase 12's
    shapes and at every head width the JAX package runs (Dh 16, 32, 64, 96,
    128, 256) and those of the scalar path (Dh 2, 12, 36 in bf16), B=1 and
    T=1, LARoPE-like positions; each case also from a column slice of a
    fused projection (rows strided). Timed in bf16 at the cell's shapes;
    no one PyTorch call computes it (library_ms None)."""
    edges = [(2, 9, 2, dh, bias) for dh in (2, 12, 16, 32, 36, 64, 96, 128, 256)
             for bias in (False, True)]
    edges += [(1, 1, 8, 64, True), (1, 448, 8, 64, True), (64, 370, 8, 64, False),
              (64, 448, 8, 64, False)]
    cases = block_cases(edges, cell, serving, widths, "bias_rope")
    for (b, t, h, dh, with_bias), n_cell in sorted(cases.items()):
        d = h * dh
        pos = torch.rand((b, t), generator=gen, device=DEV) * 100.0
        cos, sin = layers.rope_angles(pos, dh, 10000.0)
        bias = 0.5 * torch.randn(d, generator=gen, device=DEV) if with_bias else None
        for dtype in (torch.float32, torch.bfloat16):
            wide = torch.randn((b, t, 3 * d), generator=gen, device=DEV).to(dtype)
            y = wide[..., :d].contiguous()
            for form, inp in (("", y), (", a fused projection's slice", wide[..., d:2 * d])):
                got = rope.bias_rope(inp, bias, cos, sin, h)
                ref = rope.bias_rope_plain(inp, bias, cos, sin, h)
                torch.cuda.synchronize()
                ok = bits_equal(got, ref) and got.is_contiguous()
                err = float((got.float() - ref.float()).abs().max())
                log(f"  bias_rope B{b} x T{t} H{h} Dh{dh}{' + bias' if with_bias else ''}"
                    f"{form} {dtype}: bit-equal {ok} (max abs err {err:g})")
                if not ok:
                    raise AssertionError("bias_rope disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and b * t < CELL_ROWS // 2:
                continue
            rows, es = b * t, y.element_size()
            measure(results, "bias_rope", f"B{b} x T{t} H{h} Dh{dh}{' bias' if with_bias else ''}",
                    dtype, n_cell, 0.0, lambda: rope.bias_rope(y, bias, cos, sin, h),
                    lambda: rope.bias_rope_plain(y, bias, cos, sin, h),
                    2 * es * rows * d + 4 * rows * dh + (4 * d if with_bias else 0),
                    (4 if with_bias else 3) * rows * d, shape=(b, t, h, dh, with_bias),
                    ops_dtype=torch.float32)


def check_gated_residual(gen, cell, results, serving, widths):
    """The gated residual bit-equal to its plain version, with and without
    the gate and the bias, at the cell's, the servers' and phase 12's shapes
    and at edges: D no multiple of 8 (bf16: the scalar pass), D past 4,096,
    B=1 and T=1, one gate row for all. Timed in bf16 at the cell's shapes;
    library_ms is torch.addcmul(x, gate, y) (the residual and the gate in
    one call, no bias), or x + y without a gate."""
    edges = [(1, 1, 8, True, True), (3, 37, 200, True, True), (2, 7, 36, True, True),
             (2, 7, 36, False, True), (2, 5, 4104, True, False), (5, 100, 512, True, True),
             (64, 37, 256, False, True), (1, 448, 512, True, False),
             (64, 448, 512, True, False)]
    cases = block_cases(edges, cell, serving, widths, "gated_residual")
    for (b, t, d, gated, with_bias), n_cell in sorted(cases.items()):
        bias = 0.5 * torch.randn(d, generator=gen, device=DEV) if with_bias else None
        for dtype in (torch.float32, torch.bfloat16):
            x, y = (torch.randn((b, t, d), generator=gen, device=DEV).to(dtype)
                    for _ in range(2))
            gates = [None]
            if gated:
                gates = [modulation(gen, b, d, dtype)[2]]
                if (b, t, d) == (3, 37, 200):
                    gates.append(modulation(gen, b, d, dtype, rows=1)[2])
            for gate in gates:
                got = gated_residual.gated_residual(x, y, bias, gate)
                ref = gated_residual.gated_residual_plain(x, y, bias, gate)
                torch.cuda.synchronize()
                ok = bits_equal(got, ref)
                err = float((got.float() - ref.float()).abs().max())
                log(f"  gated_residual B{b} x T{t} D{d}{' gated' if gate is not None else ''}"
                    f"{' (one gate row)' if gate is not None and gate.shape[0] == 1 else ''}"
                    f"{' + bias' if with_bias else ''} {dtype}: bit-equal {ok} "
                    f"(max abs err {err:g})")
                if not ok:
                    raise AssertionError("gated_residual disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and b * t < CELL_ROWS // 2:
                continue
            gate = gates[0]
            es, rows = x.element_size(), b * t
            lib = ((lambda: torch.addcmul(x, gate, y)) if gated else (lambda: torch.add(x, y)))
            measure(results, "gated_residual",
                    f"B{b} x T{t} D{d}{' gated' if gated else ''}{' bias' if with_bias else ''}",
                    dtype, n_cell, 0.0, lambda: gated_residual.gated_residual(x, y, bias, gate),
                    lambda: gated_residual.gated_residual_plain(x, y, bias, gate),
                    3 * es * rows * d + (4 * d if with_bias else 0) + (es * b * d if gated else 0),
                    (1 + gated + with_bias) * rows * d, lib=lib, shape=(b, t, d, gated, with_bias),
                    ops_dtype=torch.float32)


def conv_inputs(gen, key, dtype):
    """x, w (HIO), bias and the options of a conv shape key (B, T, Cin,
    Cout, k, dilation, options) as ops.record_launches names them: a [T]
    mask with a run of pad frames, a [B, T] one with rows of other lengths
    and, at B >= 3, an all-masked row."""
    b, t, cin, cout, k, d, opts = key
    parts = set(opts.split("+")) if opts else set()
    fold = next((int(o[4:]) for o in parts if o.startswith("fold")), 1)
    x = torch.randn((b, t, cin), generator=gen, device=DEV).to(dtype)
    w = (torch.randn((k, cin, cout), generator=gen, device=DEV) / (k * cin) ** 0.5).to(dtype)
    bias = 0.3 * torch.randn(cout, generator=gen, device=DEV)
    frames = torch.arange(t * fold, device=DEV)
    mask = None
    if "mask" in parts:
        mask = (frames < t * fold - max(1, t * fold // 7)).float()
    elif "row_mask" in parts:
        lens = torch.tensor([t * fold - (i * t * fold) // max(b, 2) for i in range(b)],
                            device=DEV)
        if b >= 3:
            lens[-1] = 0
        mask = (frames[None] < lens[:, None]).float()
    residual = (torch.randn((b, t, cout), generator=gen, device=DEV).to(dtype)
                if "residual" in parts else None)
    kw = dict(dilation=d, silu_in="silu_in" in parts, silu_out="silu_out" in parts,
              mask=mask, fold=fold, residual=residual, tanh_f32="tanh" in parts,
              int16="int16" in parts)
    return x, w, bias, kw


def check_conv1d(gen, cell, results, serving, widths):
    """The conv kernel against its plain version at the cell's, the servers',
    the mesh's, phase 12's and the fused_resblocks=False engine's shapes and
    at edges: T no multiple of the 128-frame tile, T below the conv's reach
    k d, a [B, T] mask with an all-masked row, channels no multiple of 64,
    Cout below a panel, Cin 1024 and Cout 3072, and the domain the earlier
    kernel refused: Cin 15 and 30, Cout 15 and 250 (silu in, tanh), k 4
    (SAME: one frame less on the left), k 11 at d 9 (reach 90 frames: two
    tap groups), a fold of 4 with 36 columns a fine frame and its mask, and
    _resblock's call sites (conv a: silu in and out, mask; conv b: mask,
    residual), the head's int16 egress (bit for bit the encoding of the same
    kernel's f32 tanh, at the path's shapes, Cout 32 and 15). f32 within
    conv1d.F32_RTOL of the output's scale (exact f32 sums
    in another order); bf16 by conv1d.bf16_within (every element within
    2^-5 of the conv's rounded output and 2^-7 of the result: one bf16
    step of the conv's output carried through silu, the residual and tanh;
    the bit-equal share printed). Timed in bf16 at the cell's shapes; library_ms is F.conv1d on
    [B, C, T] tensors with its bf16 bias, the bare conv (no silu, mask,
    residual, depth-to-space or tanh, and cuDNN's bias rounding)."""
    edges = [(2, 200, 64, 64, 3, 9, "silu_in+row_mask+residual"),
             (3, 37, 64, 64, 3, 1, "silu_in+row_mask"),
             (2, 5, 64, 64, 3, 9, "silu_in+mask"), (1, 3, 96, 512, 7, 1, "mask"),
             (3, 130, 40, 24, 5, 3, ""), (2, 77, 256, 1024, 5, 1, "silu_in+mask+fold8"),
             (2, 300, 128, 32, 3, 1, "silu_in+tanh"), (2, 300, 128, 32, 3, 1, "silu_in+tanh+int16"),
             (2, 300, 20, 15, 3, 1, "silu_in+tanh+int16"),
             (3, 33, 256, 256, 5, 1, "silu_out+row_mask+residual"),
             (1, 100, 512, 512, 7, 9, "silu_in+mask"), (1, 300, 64, 64, 5, 16, "silu_in"),
             (2, 50, 1024, 1024, 5, 1, "silu_out+row_mask+residual"),
             (1, 64, 512, 3072, 5, 1, "silu_in+mask+fold8"),
             (2, 100, 15, 512, 7, 1, "mask"), (3, 70, 30, 512, 7, 1, "row_mask"),
             (2, 300, 20, 15, 3, 1, "silu_in+tanh"), (2, 200, 128, 250, 3, 1, "silu_in+tanh"),
             (3, 41, 32, 32, 4, 1, "silu_out+row_mask+residual"),
             (2, 90, 64, 144, 4, 1, "silu_in+mask+fold4"),
             (2, 150, 64, 64, 11, 9, "silu_in+silu_out+mask"),
             (1, 100, 512, 512, 11, 9, "silu_in+silu_out+mask"),
             (2, 200, 64, 64, 3, 9, "silu_in+silu_out+row_mask"),
             (2, 200, 64, 64, 3, 1, "row_mask+residual"),
             (2, 77, 36, 36, 11, 5, "mask+residual")]
    cases = block_cases(edges, cell, serving, widths, "conv1d")
    for key, n_cell in sorted(cases.items()):
        b, t, cin, cout, k, d, opts = key
        for dtype in (torch.float32, torch.bfloat16):
            x, w, bias, kw = conv_inputs(gen, key, dtype)
            if kw["int16"]:
                # the int16 egress: bit for bit the encoding of the same
                # kernel's f32 tanh, which is held to the plain version below
                i16 = conv1d.conv1d_fused(x, w, bias, **kw)
                kw = {**kw, "int16": False}
                f32_out = conv1d.conv1d_fused(x, w, bias, **kw)
                exact = i16.dtype == torch.int16 and torch.equal(
                    i16, conv1d.encode_int16(f32_out))
                log(f"  conv1d B{b} x T{t} {cin}->{cout} k{k} d{d} {opts} {dtype}: int16 "
                    f"bit-equal to the encoding of the kernel's f32 tanh {exact}")
                if not exact:
                    raise AssertionError("conv1d's int16 egress disagrees with its f32 form")
            got = conv1d.conv1d_fused(x, w, bias, **kw)
            ref = conv1d.conv1d_fused_plain(x, w, bias, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            what = f"conv1d B{b} x T{t} {cin}->{cout} k{k} d{d} {opts or 'bare'} {dtype}"
            if dtype == torch.float32:
                scale = max(1.0, float(ref.abs().max()))
                ok = err <= conv1d.F32_RTOL * scale
                log(f"  {what}: max abs err {err:.3e} (<= {conv1d.F32_RTOL:g} x {scale:.3g}) "
                    f"{ok}")
            else:
                same, ok = conv1d.bf16_within(got, x, w, bias, **kw)
                log(f"  {what}: bit-equal share {same:.6f}, within conv1d.bf16_within {ok} "
                    f"(max abs err {err:.3e})")
            if not ok or not torch.isfinite(got).all() or got.shape != ref.shape:
                raise AssertionError("conv1d disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and b * t < CELL_ROWS // 2:
                continue
            if "int16" in opts:  # the path's form: timed with its 2-byte samples
                kw = {**kw, "int16": True}
                got = conv1d.conv1d_fused(x, w, bias, **kw)
            es = x.element_size()
            xt = x.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).contiguous()
            bt = bias.to(dtype)
            pad = d * (k - 1) // 2
            nbytes = (es * (b * t * cin + k * cin * cout) + 4 * cout
                      + (4 * kw["mask"].numel() if kw["mask"] is not None else 0)
                      + (es * b * t * cout if kw["residual"] is not None else 0)
                      + got.element_size() * b * t * cout)
            measure(results, "conv1d", f"B{b} x T{t} {cin}->{cout} k{k} d{d} {opts or 'bare'}",
                    dtype, n_cell, err, lambda: conv1d.conv1d_fused(x, w, bias, **kw),
                    lambda: conv1d.conv1d_fused_plain(x, w, bias, **kw), nbytes,
                    2.0 * b * t * cin * cout * k,
                    lib=lambda: torch.nn.functional.conv1d(xt, wt, bt, padding=pad, dilation=d),
                    shape=key)


def linear_inputs(gen, key):
    """x, w, b and the form's options of a linear shape key (M, K, N, form,
    the tail's or the gate's rows a batch row, or the rope form's Dh) as
    ops.record_launches names them; the tail with rows of other lengths (at
    B >= 3 an all-masked row) and a dt a row; the rope form's angles at
    LARoPE-like positions; the residual form's gate a strided [B, 1, N]
    slice of an AdaLN-like projection (no gate where the key says 0)."""
    m, k, n, form, t = key
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=DEV) / k ** 0.5).to(torch.bfloat16)
    b = 0.3 * torch.randn(n, generator=gen, device=DEV)
    if form == "rope":
        pos = torch.rand((1, m), generator=gen, device=DEV) * 100.0
        return x.view(1, m, k), w, b, {"rope": layers.rope_angles(pos, t, 10000.0),
                                       "n_heads": n // t}
    if form == "residual":
        bsz, rows = (m // t, t) if t else (1, m)
        residual = torch.randn((bsz, rows, n), generator=gen, device=DEV).to(torch.bfloat16)
        gate = modulation(gen, bsz, n, torch.bfloat16)[2] if t else None
        return x.view(bsz, rows, k), w, b, {"residual": residual, "gate": gate}
    if form != "tail":
        return x, w, b, {"silu": form == "silu"}
    bsz = m // t
    lens = torch.tensor([t - (i * t) // max(bsz, 2) for i in range(bsz)], device=DEV)
    if bsz >= 3:
        lens[-1] = 0
    mask = (torch.arange(t, device=DEV)[None] < lens[:, None]).float()
    x_in = torch.randn((bsz, t, n), generator=gen, device=DEV) * mask[:, :, None]
    dt = 1.0 / torch.randint(1, 9, (bsz,), generator=gen, device=DEV).float()
    return x.view(bsz, t, k), w, b, {"tail": (x_in, dt, mask)}


def silu_every_bf16() -> None:
    """The silu form bit for bit F.silu of the bias form at every finite bf16
    value, through each instance that runs the silu form: x holds every
    value (repeated) in a layout that takes that instance, the weights are
    the identity (w[n, k] = 1 where n = k) and the bias zero, so the bias
    form is x itself (-0 as +0; the share where it is printed). The
    layouts: 64 x 128 tiles (ManySilu) at K = N = 128 and two tiles an SM;
    64 x 64 (Few) at M 320, K = N = 1,024, a streamed chunk's FFN-in size;
    register stores (AnyN) at N 12 off 8; the SIMT kernel at K = N = 15.
    ManySilu takes silu from the block's table (csrc/silu_table.cuh); Few
    and AnyN (one consumer a block) and the SIMT kernel the exact sequence;
    the W8A8 forms' tables are siluq_every_bf16's."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=DEV).to(torch.int16)
    vals = bits.view(torch.bfloat16)
    vals = vals[torch.isfinite(vals.float())]
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    layouts = {"bf16_many_silu": (2 * sms * 128, 128, 128), "bf16_few": (320, 1024, 1024),
               "bf16_fewer_or_any_n": (-(-vals.numel() // 12), 16, 12),
               "simt": (-(-vals.numel() // 15), 15, 15)}
    for want_instance, (m, k, n) in layouts.items():
        instance = linear.kernel_instance(m, k, n, "silu")
        cols = vals.repeat(-(-m * n // vals.numel()))[:m * n].view(m, n)
        x = torch.zeros(m, k, dtype=torch.bfloat16, device=DEV)
        x[:, :n] = cols
        w = torch.eye(n, k, dtype=torch.bfloat16, device=DEV)
        b = torch.zeros(n, device=DEV)
        own = linear.linear(x, w, b)
        got = linear.linear(x, w, b, silu=True)
        want = torch.nn.functional.silu(own)
        exact = bits_equal(got, want)
        same = float((own.view(torch.int16) == (cols + 0.0).view(torch.int16)).float().mean())
        n_diff = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        log(f"  linear silu form at every finite bf16 value ({vals.numel()}, M {m} K {k} N {n}, "
            f"instance {instance}; the bias form is x at a share {same:.6f}): bit-equal to "
            f"F.silu of the bias form {exact} ({n_diff} values differ)")
        if instance != want_instance:
            raise AssertionError(f"the silu layout for {want_instance} ran {instance}")
        if not exact:
            raise AssertionError(f"the linear kernel's silu ({instance}) differs from F.silu")


def siluq_every_bf16() -> None:
    """The W8A8 silu-quantize form (its silu from the block's table) at every
    finite bf16 value: one row a value, X[:, 0] = 1 and W's columns a single
    1 at k = 0 (K 32, the rest 0), the weight scales 1 and the bias 0, so a
    row's rescaled bias form is rnd(sx[row]) and sx holds each of the 65,280
    finite bf16 values (-0 as +0), across N 2,048 (a cluster of 16 blocks).
    Its outputs, xq = +-127 (or 0) and sx = max(|silu(v)|, 1e-12) / 127,
    distinct for every distinct |silu(v)| above the clamp, with xq's sign
    give the table's bits: (xq, sx) must be bit for bit the plain version's
    (F.silu on the card, then quantize_rows_plain) on the same card
    tensors. Then the W8A8 silu form (csrc/int8_matmul.cu, its silu from the
    table too) on the same operands, bit for bit F.silu of its own bias form
    through each of its instances: 64 x 64 tiles of four consumers at N
    2,048, of two (few tiles) at N 64 over two launches of half the values,
    and register stores at N 3. It raises otherwise."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=DEV).to(torch.int16)
    vals = bits.view(torch.bfloat16)
    vals = vals[torch.isfinite(vals.float())]

    def operands(rows, n, k=32):
        xq = torch.zeros((rows.numel(), k), dtype=torch.int8, device=DEV)
        xq[:, 0] = 1
        w = torch.zeros((n, k), dtype=torch.int8, device=DEV)
        w[:, 0] = 1
        return (xq, rows.float(), w, torch.ones(n, device=DEV), torch.zeros(n, device=DEV),
                torch.bfloat16)

    m, n = vals.numel(), 2048
    args = operands(vals, n)
    hq, hs = w8a8.w8a8_matmul(*args, silu=True, quantize=True)
    pq, ps = w8a8.w8a8_matmul_plain(*args, silu=True, quantize=True)
    torch.cuda.synchronize()
    exact = bits_equal(hq, pq) and bits_equal(hs, ps)
    n_diff = int((hs.view(torch.int32) != ps.view(torch.int32)).sum()
                 + (hq != pq).any(-1).sum())
    log(f"  w8a8_matmul silu-quantize form at every finite bf16 value ({m} rows, K 32 N {n}; "
        f"{int(torch.unique(hs).numel())} distinct sx): (xq, sx) bit-equal to the plain version "
        f"{exact} ({n_diff} rows differ)")
    if not exact:
        raise AssertionError("the W8A8 silu-quantize form's silu differs from F.silu")
    del hq, hs, pq, ps
    for label, n, parts in (("64 x 64, four consumers", 2048, 1), ("64 x 64, few tiles", 64, 2),
                            ("register stores", 3, 1)):
        n_diff = 0
        for rows in vals.chunk(parts):
            args = operands(rows, n)
            got = w8a8.w8a8_matmul(*args, silu=True)
            want = torch.nn.functional.silu(w8a8.w8a8_matmul(*args))
            n_diff += int((got.view(torch.int16) != want.view(torch.int16)).sum())
        log(f"  w8a8_matmul silu form at every finite bf16 value ({label}: N {n}, "
            f"{parts} launch{'es' if parts > 1 else ''}): bit-equal to F.silu of its bias form "
            f"{n_diff == 0} ({n_diff} values differ)")
        if n_diff:
            raise AssertionError(f"the W8A8 silu form's silu ({label}) differs from F.silu")


def check_linear(gen, cell, results, serving, widths):
    """The linear kernel against its plain version (cuBLAS's product, then
    add_bias: JAX's bf16 bias rounding) at the cell's, the servers', the
    mesh's and phase 12's shapes and at edges: M off the 64-row tile, K 96
    (half a 64-element stage zero), K off 8 (the SIMT route), N 1, 96 and
    off 8 (register stores), N 4,608 at M 64, a tail with an all-masked row.
    First the silu form at every finite bf16 value (silu_every_bf16).
    The bias form within linear.bf16_within (one bf16 step of the product,
    which cuBLAS sums in another order, carried through the bias add; the
    bit-equal share printed); the silu form bit for bit F.silu of the
    kernel's own bias form, and within bf16_within; the tail form bit for bit
    linear.euler_tail of the kernel's own bias form. Timed at the cell's
    shapes and at those a streamed chunk launches (its B = 1 rows); library_ms
    is F.linear(x, w, bias in bf16): cuBLAS's product with its bias epilogue
    (in f32 before the one rounding, not JAX's rounding), without the silu,
    tail, rotation or residual; the kernels line takes a bias form's row.
    The edges also take each instance at ragged rows and columns: 128 x 128
    tiles (64 x 128 for silu) at M off 128 (M 17,037), the tail's 96-column
    tiles at N 200 and its register stores at N 30.
    The rope form (the Q and K projections) bit for bit
    rope.bias_rope_plain of the kernel's own bias form, at every head width
    the JAX package runs (Dh 16, 32, 64, 96, 128, 256) and 192, each
    instance (128 x 128 at Dh 64 and ragged M, 64 x 64 at a streamed
    chunk's M, 64 x 192, 64 x 256) and on the SIMT kernel (K off 8; Dh 12
    and 36, whose halves no 8-column group holds: there its own bias form
    from a zero column more, which puts K off 8); the residual form (O and
    the FFN's second linear) bit for bit gated_residual.gated_residual_plain
    of the kernel's own bias form, with a gate of B rows (strided), of one
    row for all, of rows at an odd element (copied by the wrapper) and
    without a gate, on 128 x 128, 64 x 64 and register-stored tiles (N off
    8) and the SIMT kernel. Timed beside the pair each replaces: F.linear,
    then the bias-and-rope or gated-residual kernel."""
    edges = [(37, 96, 96, "bias", 0), (37, 96, 96, "tail", 37), (130, 256, 1, "bias", 0),
             (17037, 256, 256, "bias", 0), (17037, 256, 512, "silu", 0),
             (3 * 50, 256, 200, "tail", 50), (2 * 50, 64, 30, "tail", 50),
             (64, 512, 4608, "bias", 0), (300, 15, 64, "bias", 0), (300, 64, 15, "silu", 0),
             (200, 512, 2048, "silu", 0), (3 * 50, 512, 96, "tail", 50),
             (4 * 33, 15, 15, "tail", 33), (1000, 256, 1024, "silu", 0)]
    edges += [(300, 64, 32, "rope", 16), (300, 64, 64, "rope", 32), (17037, 512, 512, "rope", 64),
              (448, 512, 512, "rope", 64), (50, 256, 256, "rope", 64),
              (200, 384, 384, "rope", 96), (37, 384, 96, "rope", 96), (150, 512, 384, "rope", 192),
              (300, 256, 256, "rope", 128), (200, 1024, 1024, "rope", 256),
              (100, 64, 48, "rope", 12), (100, 72, 72, "rope", 36), (64, 15, 64, "rope", 64),
              (37, 96, 96, "residual", 37), (3 * 50, 256, 256, "residual", 50),
              (17037, 512, 512, "residual", 0), (300, 1024, 256, "residual", 0),
              (2 * 50, 64, 30, "residual", 50), (130, 15, 64, "residual", 0),
              (4 * 33, 15, 15, "residual", 33), (448, 512, 512, "residual", 448),
              (2 * 32, 2048, 512, "residual", 32)]
    # the residual form's many-tile instance at M off the 64-row tile, N off
    # 128, K 256 and 1,024, and gate rows of three or more batch rows in a
    # tile (T 50: the third read from device memory)
    edges += [(17037, 256, 256, "residual", 0), (17037, 512, 200, "residual", 0),
              (17050, 512, 512, "residual", 50), (17037, 1024, 256, "residual", 0),
              (17037, 1024, 200, "residual", 0), (17050, 1024, 256, "residual", 50)]
    silu_every_bf16()
    pairs = {"rope": [], "residual": []}  # (launches, kernel ms, pair ms) from graphs
    cases = block_cases(edges, cell, serving, widths, "linear")
    for key, n_cell in sorted(cases.items()):
        m, k, n, form, t = key
        x, w, b, kw = linear_inputs(gen, key)
        got = linear.linear(x, w, b, **kw)
        own = linear.linear(x, w, b)
        same, ok = linear.bf16_within(own, x, w, b)
        err = float((own.float() - linear.linear_plain(x, w, b).float()).abs().max())
        per_chunk = serving["linear"].get(key, 0)  # launches per streamed chunk
        what = (f"linear M{m} K{k} N{n} {form}{f' (T {t})' if t else ''}"
                f"{f' ({per_chunk} per streamed chunk)' if per_chunk else ''}")
        if form == "silu":
            _same, within = linear.bf16_within(got, x, w, b, silu=True)
            exact = bits_equal(got, torch.nn.functional.silu(own))
            ok = ok and within and exact
            log(f"  {what}: bias form bit-equal share {same:.6f} (max abs err {err:.3e}), "
                f"both forms within linear.bf16_within {ok}, silu form bit-equal to F.silu "
                f"of the kernel's bias form {exact}")
        elif form == "tail":
            exact = bits_equal(got, linear.euler_tail(own, kw["tail"]))
            ok = ok and exact and got.dtype == torch.float32
            log(f"  {what}: bias form bit-equal share {same:.6f} within linear.bf16_within "
                f"(max abs err {err:.3e}), tail bit-equal to the plain tail of the kernel's "
                f"bias form {exact}")
        elif form in ("rope", "residual"):
            exact, instance = epilogue_forms(gen, key, x, w, b, kw, got, own)
            ok = ok and exact
            log(f"  {what} ({instance}): bias form bit-equal share {same:.6f} within "
                f"linear.bf16_within (max abs err {err:.3e}), {form} form bit-equal to the "
                f"plain {'rotation' if form == 'rope' else 'gated residual'} of the kernel's "
                f"bias form {exact}")
        else:
            log(f"  {what}: bit-equal share {same:.6f}, within linear.bf16_within {ok} "
                f"(max abs err {err:.3e})")
        torch.cuda.synchronize()
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError("linear disagrees with its plain version")
        # timed: the cell's shapes, a streamed chunk's and the large off-cell ones
        if not (n_cell or per_chunk or n_cell == 0 and m >= CELL_ROWS // 2):
            continue
        bb = b.to(torch.bfloat16)
        x2 = x.reshape(-1, k)
        nbytes = 2 * (m * k + n * k) + 4 * n + got.element_size() * m * n
        if form == "tail":
            nbytes += 4 * m * n + 4 * m + 4 * (m // t)  # x_in, the mask, dt
        if form == "rope":
            nbytes += 4 * m * t  # cos and sin, [M, Dh / 2] f32 each
        if form == "residual":
            nbytes += 2 * m * n + (2 * (m // t) * n if t else 0)  # the residual, the gate
        measure(results, "linear", what[len("linear "):], torch.bfloat16, n_cell or 0, err,
                lambda: linear.linear(x, w, b, **kw), lambda: linear.linear_plain(x, w, b, **kw),
                nbytes, 2.0 * m * n * k, lib=lambda: torch.nn.functional.linear(x2, w, bb),
                shape=key, line=form == "bias")
        if form in pairs:
            # the pair the form replaces: cuBLAS's product, then the
            # bias-and-rope or gated-residual kernel
            def pair():
                y = torch.nn.functional.linear(x, w)
                if form == "rope":
                    return rope.bias_rope(y, b, *kw["rope"], kw["n_heads"])
                return gated_residual.gated_residual(kw["residual"], y, b, kw["gate"])
            pair_ms, pair_graph = time_ms(pair), graph_ms(pair)
            row = results["linear"][-1]
            after = "bias_rope" if form == "rope" else "gated_residual"
            log(f"    the pair it replaces (F.linear, then {after}): {pair_ms:.4f} ms [graph "
                f"{pair_graph:.4f}]; the form {row['ms']:.4f} [graph {row['graph_ms']:.4f}]")
            if n_cell:
                pairs[form].append((n_cell, row["graph_ms"], pair_graph, row["bound_ms"]))
            if form == "residual":  # the residual form's entry: no one PyTorch call computes it
                results["linear residual form"].append(dict(
                    row, line=True, library_ms=None, library_graph_ms=None, pair_ms=pair_graph))
    for form, rows in pairs.items():
        if rows:
            log(f"  linear {form} form per b64/5-step batch at the cell's shapes "
                f"({sum(r[0] for r in rows)} launches), from graphs: "
                f"{sum(r[0] * r[1] for r in rows):.4f} ms, the pairs it replaces "
                f"{sum(r[0] * r[2] for r in rows):.4f} ms, bound "
                f"{sum(r[0] * r[3] for r in rows):.4f} ms")


def epilogue_forms(gen, key, x, w, b, kw, got, own) -> tuple[bool, str]:
    """The rope or residual form ``got`` of a linear shape key bit for bit
    the plain rotation or gated residual of the kernel's own bias form
    ``own`` (for a rope form on the SIMT kernel at a K that takes the
    wgmma kernels, the SIMT kernel's own bias form: a zero column more puts K
    off 8 and adds nothing to its sums); the residual form also with a gate of
    one row for all and with gate rows at an odd element. Returns (exact,
    the instance the form took)."""
    m, k, n, form, t = key
    if form == "rope":
        instance = linear.kernel_instance(m, k, n, "rope", t)
        if instance == "simt" and k % 8 == 0:
            pad = torch.nn.functional.pad
            own = linear.linear(pad(x, (0, 1)), pad(w, (0, 1)), b)
        want = rope.bias_rope_plain(own, None, *kw["rope"], kw["n_heads"])
        return bits_equal(got, want), instance
    instance = linear.kernel_instance(m, k, n, "residual")
    residual, gate = kw["residual"], kw["gate"]
    exact = bits_equal(got, gated_residual.gated_residual_plain(residual, own, None, gate))
    if gate is not None:
        one = modulation(gen, 1, n, torch.bfloat16, rows=1)[2]
        odd = torch.randn((gate.shape[0], 1, n + 1), generator=gen,
                          device=DEV).to(torch.bfloat16)[..., 1:]
        for g in (one, odd):
            out = linear.linear(x, w, b, residual=residual, gate=g)
            exact = exact and bits_equal(
                out, gated_residual.gated_residual_plain(residual, own, None, g))
    return exact, instance


# the SASS instructions each library must hold (and, for the int8 library,
# must not): bf16 wgmma (HGMMA), integer wgmma (IGMMA), TMA loads and stores
# (UTMALDG, UTMASTG), bulk copies to and from shared memory (UBLKCP), and
# the mma.sync of the replaced int8 design (IMMA)
SASS_REQUIRED = {"attention": ("HGMMA", "UTMALDG"), "ffn": ("HGMMA", "UTMALDG"),
                 "resblock_chain": ("HGMMA", "UTMALDG"),
                 "int8_matmul": ("IGMMA", "UTMALDG", "UTMASTG"), "quantize": ("UBLKCP",),
                 "conv1d": ("HGMMA", "UTMALDG"), "ln_modulate": ("UBLKCP",),
                 "linear": ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG")}
SASS_FORBIDDEN = {"int8_matmul": ("IMMA",)}


def check_instructions(libs) -> None:
    """The bf16 attention, FFN and chain, the int8 product and the quantize
    pass run on Hopper's own instructions: count wgmma (SASS HGMMA, IGMMA),
    TMA loads and stores (UTMALDG, UTMASTG) and bulk copies (UBLKCP) in
    each library's code, and print the tiles each kernel chose."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, required in SASS_REQUIRED.items():
        sass = subprocess.run([tool, "-sass", str(libs[name])], capture_output=True, text=True,
                              check=True).stdout
        forbidden = SASS_FORBIDDEN.get(name, ())
        found = {op: len(re.findall(rf"\b{op}\b", sass)) for op in required + forbidden}
        log(f"  lib{name}.so: " + ", ".join(f"{n} {op}" for op, n in found.items()))
        if not all(found[op] for op in required) or any(found[op] for op in forbidden):
            raise AssertionError(f"lib{name}.so: instructions {found}, required {required}, "
                                 f"forbidden {forbidden}")
    log(f"  attention tiles: {attention.kernel_tiles()}")
    log(f"  adaln_ffn tiles (rows, columns, stages): {ffn.kernel_tiles()}")
    for c in vocoder_fused.CHAIN_WIDTHS:
        for half in (False, True)[:1 + (c <= 256)]:
            log(f"  resblock_chain bf16 layout at C={c}: {vocoder_fused.kernel_layout(c, half)}")
    log(f"  int8_matmul tiles (rows, columns, stages): {int8_matmul.kernel_tiles()}")
    log(f"  linear tiles (rows, columns, stages): {linear.kernel_tiles()}")
    # the instances the Q, K and O projections' forms take at the b64 cell's
    # shapes, a streamed chunk's and phase 12's head widths
    for m, k, n, form, dh in ((28672, 512, 512, "rope", 64), (20480, 256, 256, "rope", 64),
                              (448, 512, 512, "rope", 64), (1280, 384, 384, "rope", 96),
                              (1280, 256, 256, "rope", 128), (1280, 1024, 1024, "rope", 256),
                              (1280, 512, 384, "rope", 192), (1280, 72, 72, "rope", 36),
                              (28672, 512, 512, "residual", 0), (20480, 1024, 256, "residual", 0),
                              (448, 512, 512, "residual", 0), (320, 256, 256, "residual", 0)):
        log(f"  linear {form} form at M {m} K {k} N {n}{f' Dh {dh}' if dh else ''}: "
            f"{linear.kernel_instance(m, k, n, form, dh)}")
    # the W8A8 product's forms at the int8 cell's, a streamed chunk's and
    # phase 12's VE shapes (the rope form at Dh 16-128 on tiles of its own:
    # w8a8.kernel_instance's "rope_many")
    for m, k, n, form, dh in ((28672, 512, 512, "rope", 64), (23680, 512, 512, "rope", 64),
                              (448, 512, 512, "rope", 64), (1280, 256, 256, "rope", 128),
                              (1280, 96, 72, "rope", 36), (28672, 512, 512, "residual", 0),
                              (28672, 2048, 512, "residual", 0), (448, 512, 512, "residual", 0),
                              (448, 2048, 512, "residual", 0)):
        log(f"  w8a8_matmul {form} form at M {m} K {k} N {n}{f' Dh {dh}' if dh else ''}: "
            f"{w8a8.kernel_instance(m, k, n, form, dh)}")
    for b, t_len, c in ((64, 28672, 128), (64, 3584, 256), (1, 896, 256), (1, 7168, 128)):
        tile = vocoder_fused._tile(c, 3, (1, 3, 9), torch.bfloat16, b, t_len)
        log(f"  resblock_chain bf16 tile at B{b} x {t_len} frames, C={c}: {tile} output frames "
            f"a block, {b * -(-t_len // tile)} blocks")


def cell_summary(results, launches) -> dict:
    """Per kernel: the row (in the path's own dtype: bf16, or int8 for the
    int32 product) of the cell's shape that spends the most kernel time per
    batch among those that may stand in the kernels line (the linear
    kernel's bias form, whose library call is the same function), and the
    per-batch sums over the cell's shapes (for a kernel the path no longer
    launches, the sums it would take at the path's counts). The bias-and-rope
    and gated-residual kernels left the b64 path (the linear kernel's and the
    W8A8 product's epilogues took them; they serve fused projections, f32
    and sharded linears): their rows are the timed ones at the shapes the
    int8 VE gave them before, with 0 launches on the path."""
    line = {}
    for kernel, rows in results.items():
        cell = [r for r in rows if r["n_cell"] and r["dtype"] != torch.float32]
        if not cell and kernel in EPILOGUE_KERNELS and not launches[kernel]:
            timed = [r for r in rows if r["dtype"] != torch.float32 and r["n_cell"] == 0]
            if not timed:
                raise AssertionError(f"{kernel}: no timed shape")
            line[kernel] = max(timed, key=lambda r: r["ms"])
            log(f"  {kernel}: off the b64 path (0 launches on it); its kernels line row at "
                f"{line[kernel]['name']}")
            continue
        if not cell:
            raise AssertionError(f"{kernel}: no shape recorded on the cell's path")
        sums = {key: (None if any(r[key] is None for r in cell)
                      else f"{sum(r['n_cell'] * r[key] for r in cell):.4f}")
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "earlier_ms",
                            "graph_ms", "library_graph_ms")}
        where = ("per b64/5-step batch at the cell's shapes" if kernel != "int8_matmul"
                 else "per TP int8 batch of phase 11 (b), at its shapes")
        log(f"  {kernel} {where} ({cell[0]['dtype']}, "
            f"{sum(r['n_cell'] for r in cell)} launches): kernel {sums['ms']} ms "
            f"[graph {sums['graph_ms']}] (earlier: {sums['earlier_ms']} ms), plain "
            f"{sums['plain_ms']} ms, library {sums['library_ms']} ms "
            f"[graph {sums['library_graph_ms']}], bound {sums['bound_ms']} ms")
        line[kernel] = max((r for r in cell if r["line"]), key=lambda r: r["n_cell"] * r["ms"])
    return line


# ---------------------------------------------------------------------------
# phases 3, 4 and 6: the main path
# ---------------------------------------------------------------------------

def smoke_params(cfg: TTSConfig, seed: int = 0):
    """init_all with the zero-init heads of the vector estimator perturbed
    (otherwise gate = 0 and the attention and FFN sublayers are multiplied
    by zero)."""
    params = init_all(seed, cfg)
    rng = np.random.default_rng(42)
    ve = params["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return params


def check_audio(wav: np.ndarray, dur: float, sr: int, what: str) -> None:
    n = int(sr * dur)
    if not np.isfinite(wav).all():
        raise AssertionError(f"{what}: non-finite audio")
    if wav.shape[-1] < n:
        raise AssertionError(f"{what}: {wav.shape[-1]} samples < duration {dur:.3f}s")
    rms = float(np.sqrt(np.mean(np.square(wav[..., :n]))))
    if rms <= 0.005:
        raise AssertionError(f"{what}: RMS {rms:.5f} <= 0.005")


def recorded(eng, run, tries: int = 3):
    """Run ``run()`` with the launch counts reset and the launches tallied
    by shape (``ops.record_launches``: replays credit what their capture
    recorded); again if it met a program key for the first time, whose
    eager run would count beside its replay. Returns (tally, counts)."""
    for _ in range(tries):
        n_programs = programs_count(eng)
        ops.reset_launch_counts()
        with ops.record_launches() as tally:
            run()
        if programs_count(eng) == n_programs:
            return tally, ops.launch_counts()
    raise AssertionError(f"each of {tries} runs captured a new program")


def check_exact(counts, per_batch, what) -> None:
    """Exactly per_batch launches of each kernel."""
    log(f"  launches over {what}: {counts} (exactly {per_batch} required)")
    if counts != per_batch:
        raise AssertionError(f"launches over {what}: {counts}, expected {per_batch}")


def check_launches(counts, per_batch, n_batches, what) -> None:
    """At least per_batch launches of each kernel per batch; exactly 0 of a
    kernel the path must not reach."""
    log(f"  launches over {what}: {counts} (per batch: {per_batch})")
    for name, n in per_batch.items():
        if (counts[name] != 0) if n == 0 else (counts[name] < n * n_batches):
            raise AssertionError(f"{name}: {counts[name]} launches over {what}, "
                                 f"expected {'0' if n == 0 else f'>= {n * n_batches}'}")


def main_path(assets, precision, profile: bool, pin_rate: bool, bf16_rates=None):
    """Drive TTS(assets, precision=...) through the counted run and the b64
    batches; return the shapes each kernel wrapper was given in one
    b64/5-step batch, the b64 audio-sec/s by step count and the launch
    counts of the counted run. ``pin_rate``: every latent bucket from a
    fixed 1/11 s/char, no rate learned."""
    t0 = time.perf_counter()
    tts = TTS(assets, precision=precision)  # device defaults to cuda
    if pin_rate:
        tts.engine._pin_rate(1.0 / 11.0)
        tts.engine._rate_frozen = True
    n_params = count_params(tts.assets.params)
    log(f"  TTS() on {tts.engine.device}, precision={tts.engine.precision}, "
        f"{n_params / 1e6:.2f}M params, load {time.perf_counter() - t0:.2f}s")
    per_batch = PER_BATCH[precision]
    if tts.sample_rate != 44100:
        raise AssertionError(f"sample rate {tts.sample_rate}")
    style = tts.get_voice_style("M1")
    # warm the allocator and cuBLAS outside the counted run
    tts.synthesize(SHORT_TEXT, style, total_step=1)
    ops.reset_launch_counts()
    n_batches = 0
    for text in TEXTS:
        wav, dur = tts.synthesize(text, style, total_step=5)
        n_batches += 1
        check_audio(wav[0], float(dur[0]), tts.sample_rate, f"synthesize {len(text)} chars")
        if abs(wav.shape[1] - int(tts.sample_rate * float(dur[0]))) > 1:
            raise AssertionError("synthesize: length != duration")
        log(f"  synthesize {len(text)} chars: {float(dur[0]):.3f}s audio")
    texts = [TEXTS[i % 3] for i in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs, durs = tts.synthesize_batch(texts, ["en"] * 16, style.tile(16), total_step=5)
    wall = time.perf_counter() - t0
    n_batches += 1
    for i, (w, d) in enumerate(zip(wavs, durs)):
        check_audio(w, float(d), tts.sample_rate, f"batch row {i}")
    counts = ops.launch_counts()
    log(f"  synthesize_batch b16/5-step: {float(durs.sum()):.3f}s audio in {wall:.3f}s "
        f"= {float(durs.sum()) / wall:.2f} audio-sec/s")
    # synthesize and the b16 batch ran at 5 steps, like the per-batch counts
    check_launches(counts, per_batch, n_batches, f"{n_batches} batches")
    # throughput at b64, the system's metric (5 and 2 steps)
    texts = [TEXTS[i % 3] for i in range(64)]
    rates, walls = {}, {}
    for steps in (5, 2):
        tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=steps)
        if steps == 5:  # the rate is learned: this batch runs at the cell's buckets
            cell, one = recorded(tts.engine, lambda: tts.synthesize_batch(
                texts, ["en"] * 64, style.tile(64), total_step=5))
            log(f"  shapes given to each kernel in one b64/5-step batch: {cell}")
            check_exact(one, per_batch, "one b64/5-step batch (a replay of its program)")
        rates[steps], walls[steps] = [], []
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _w, d = tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=steps)
            wall = time.perf_counter() - t0
            rates[steps].append(float(d.sum()) / wall)
            walls[steps].append(wall)
            beside = "" if bf16_rates is None else (
                f" (bf16, phase 3: {' / '.join(f'{r:.2f}' for r in bf16_rates[steps])})")
            log(f"  {precision} b64/{steps}-step rep {rep}: {float(d.sum()):.3f}s audio in "
                f"{wall:.4f}s = {rates[steps][-1]:.2f} audio-sec/s{beside}")
    egress_host_cost(tts, texts, style)
    fused_replay_vs_eager(tts.engine, texts, style)
    trace_replayed_batch(tts, texts, style, per_batch, float(np.median(walls[5])))
    if profile:
        profile_batch(tts, texts, style)
    log_programs(tts.engine, f"the {precision} engine")
    return cell, rates, counts


def egress_host_cost(tts, texts, style, reps: int = 20) -> None:
    """Median host ms a b64/5-step dispatch spends on its own noise
    generator, the event recorded behind it and queueing its duration and
    waveform copies on the egress stream; beside them, on the same tensors
    and an idle card, the whole fetch (queue and wait), the synchronous
    copies into pinned memory that a single-stream engine makes, and the
    host's int16 -> f32 decode of the fetched waveform (outside any
    graph)."""
    eng = tts.engine
    p = eng.infer_batch_begin(texts, ["en"] * len(texts), style.tile(len(texts)), 5)
    eng.infer_batch_end(p)
    dur, wav = p.dur_dev, p.wav_src
    names = ("generator", "event", "queue copies", "fetch and wait", "synchronous copies",
             "decode")
    ms = {name: [] for name in names}
    with torch.inference_mode():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._next_generator()
            t1 = time.perf_counter()
            ready = eng._mark()
            t2 = time.perf_counter()
            fetch = eng._fetch([dur, wav], ready)
            t3 = time.perf_counter()
            _dur_host, wav_host = eng._wait(fetch)
            t4 = time.perf_counter()
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            dur.cpu()
            torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True).copy_(wav)
            t6 = time.perf_counter()
            eng._decode_egress(wav_host)
            t7 = time.perf_counter()
            for name, dt in zip(names, (t1 - t0, t2 - t1, t3 - t2, t4 - t2, t6 - t5, t7 - t6)):
                ms[name].append(dt * 1e3)
    log(f"  host ms per b64/5-step dispatch ({wav.numel() * wav.element_size() / 2**20:.1f} "
        f"MiB of {wav.dtype} waveform), median of {reps}: " + ", ".join(
            f"{name} {float(np.median(v)):.4f}" for name, v in ms.items()))


def profile_batch(tts, texts, style) -> None:
    """Where one b64/5-step batch spends device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's first start-up, outside the window
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        tts.synthesize_batch(texts, ["en"] * len(texts), style.tile(len(texts)),
                             total_step=5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    tts.engine.processor(texts, ["en"] * len(texts))
    log(f"  frontend (host) for {len(texts)} texts: "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  profile b64/5-step: wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    log("  host ops by self CPU time (profiled, inflated by the profiler):")
    host = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"    {e.self_cpu_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")


def whole_path_inputs(n: int = 3):
    """n texts (the protocol texts, cycled), voice F1 and injected noise."""
    from supertonic_tpu_torch.assets import synthesize_default_styles

    cfg = TTSConfig()
    proc = UnicodeProcessor(build_default_indexer())
    style = synthesize_default_styles(cfg)["F1"].tile(n)
    noise = np.random.default_rng(7).standard_normal(
        (n, 640, cfg.latent_channels)).astype(np.float32)
    return cfg, proc, [TEXTS[i % 3] for i in range(n)], style, noise


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def whole_path_f32(params) -> None:
    """f32 card vs CPU on injected noise: on the card the text and acoustic
    programs' replays (captured at the first call of their keys), on the
    CPU the plain versions, eagerly."""
    cfg, proc, texts, style, noise = whole_path_inputs()
    out = {}
    for dev in ("cuda", "cpu"):
        eng = SynthesisEngine(params, cfg, proc, precision="f32", device=dev)
        t0 = time.perf_counter()
        out[dev] = eng.infer_batch(texts, ["en"] * 3, style, total_step=2, noise=noise)
        log(f"  f32 whole path on {dev}: {time.perf_counter() - t0:.2f}s")
    (wg, dg), (wc, dc) = out["cuda"], out["cpu"]
    dur_rel = float(np.max(np.abs(dg - dc) / np.abs(dc)))
    if wg.shape != wc.shape:
        raise AssertionError(f"wav shapes differ: {wg.shape} vs {wc.shape}")
    wav_err = float(np.max(np.abs(wg - wc)))
    rms = float(np.sqrt(np.mean(np.square(wc))))
    log(f"  f32 card vs CPU: max wav diff {wav_err:.3e} (atol {WHOLE_PATH_WAV_ATOL:g}; "
        f"wav RMS {rms:.4f}), duration rel diff {dur_rel:.3e} "
        f"(rtol {WHOLE_PATH_DUR_RTOL:g})")
    if wav_err > WHOLE_PATH_WAV_ATOL or dur_rel > WHOLE_PATH_DUR_RTOL:
        raise AssertionError("f32 whole path: card and CPU disagree")


def w8a8_linears(params) -> None:
    """The W8A8 linears of VE block 0 (the quantize kernel, then the int8
    kernel with its rescale-and-bias epilogue) on the card against the same
    code on the CPU (the plain versions), on the same activations, f32 and
    bf16: bit-equal, while the
    unquantized linear is far off. This separates a right quantization from
    none; the whole path cannot, since a flipped rounding of one activation
    grows, layer by layer, to the size of the quantization itself."""
    block = params["vector_estimator"]["blocks"][0]
    q_block = quantize_params({"vector_estimator": {"blocks": [block]}})
    q_block = q_block["vector_estimator"]["blocks"][0]
    gen = np.random.default_rng(9)
    for path in (("self", "q"), ("ffn", "in"), ("ffn", "out")):
        tree, q_tree = block[path[0]][path[1]], q_block[path[0]][path[1]]
        x = gen.standard_normal((4096, tree["w"].shape[0])).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            got = {}
            for dev in ("cuda", "cpu"):
                lin = layers.tree_to_modules(q_tree, device=dev)
                got[dev] = layers.linear(lin, torch.as_tensor(x).to(dev, dtype)).float().cpu()
            plain = layers.linear(layers.tree_to_modules(tree, device="cuda", dtype=dtype),
                                  torch.as_tensor(x).to(DEV, dtype)).float().cpu()
            err = float((got["cuda"] - got["cpu"]).abs().max())
            quant = float((got["cuda"] - plain).norm() / plain.norm())
            log(f"  W8A8 {'.'.join(path)} [4096, {x.shape[1]}] {dtype}: card vs CPU max "
                f"abs err {err:g} (bit-equal required); unquantized linear {quant:.3e} "
                f"away (relative L2)")
            if err != 0.0 or not quant > 0.0:
                raise AssertionError("W8A8 linear: card and CPU disagree, or no quantization")
    # the rope form (self Q, LARoPE-like angles, heads of 64) and the
    # residual form (FFN-out, a gate of a row a batch row) card against CPU:
    # in bf16 the W8A8 product's forms on the card, in f32 the product, then
    # the bias-and-rope or gated-residual kernel
    b, t = 8, 512
    for path in (("self", "q"), ("ffn", "out")):
        q_tree = q_block[path[0]][path[1]]
        k, n = q_tree["w_q"].shape
        x = gen.standard_normal((b, t, k)).astype(np.float32)
        pos = gen.uniform(0.0, 100.0, (b, t)).astype(np.float32)
        res = gen.standard_normal((b, t, n)).astype(np.float32)
        gate = (0.5 * gen.standard_normal((b, 1, n))).astype(np.float32)
        rope_cs = layers.rope_angles(torch.as_tensor(pos), 64, 10000.0)
        for dtype in (torch.float32, torch.bfloat16):
            got = {}
            for dev in ("cuda", "cpu"):
                lin = layers.tree_to_modules(q_tree, device=dev)
                xt = torch.as_tensor(x).to(dev, dtype)
                if path[1] == "q":  # the angles made once, on the CPU
                    out = layers.linear(lin, xt, rope=rope_cs, n_heads=n // 64)
                else:
                    out = layers.linear(lin, xt, residual=torch.as_tensor(res).to(dev, dtype),
                                        gate=torch.as_tensor(gate).to(dev, dtype))
                got[dev] = out.float().cpu()
            err = float((got["cuda"] - got["cpu"]).abs().max())
            form = "rope" if path[1] == "q" else "residual"
            log(f"  W8A8 {'.'.join(path)} {form} form [{b}, {t}, {k}] {dtype}: card vs CPU max "
                f"abs err {err:g} (bit-equal required)")
            if err != 0.0:
                raise AssertionError(f"W8A8 {form} form: card and CPU disagree")
    # the FFN-in's silu-quantize form (bf16): the FFN-out's (xq, sx), card vs CPU
    q_tree = q_block["ffn"]["in"]
    x = gen.standard_normal((4096, q_tree["w_q"].shape[0])).astype(np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        lin = layers.tree_to_modules(q_tree, device=dev)
        h = layers.linear(lin, torch.as_tensor(x).to(dev, torch.bfloat16), silu=True,
                          quantize=True)
        got[dev] = (h.xq.cpu(), h.sx.cpu())
    ok = all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
    log(f"  W8A8 ffn.in silu-quantize form [4096, {x.shape[1]}] bf16: (xq, sx) card vs CPU "
        f"bit-equal {ok}")
    if not ok:
        raise AssertionError("W8A8 silu-quantize form: card and CPU disagree")


def whole_path_int8(params, smi: str) -> None:
    """int8 against bf16 on the card, same texts and noise, 2 steps: the
    text stage is not quantized, so the durations are bit-equal; the wav
    moves by the W8A8 rounding, within the band set from earlier runs."""
    cfg, proc, texts, style, noise = whole_path_inputs()
    out = {}
    for precision in ("bf16", "int8"):
        eng = SynthesisEngine(params, cfg, proc, precision=precision)
        out[precision] = eng.infer_batch(texts, ["en"] * 3, style, total_step=2,
                                         noise=noise)
    (wb, db), (w8, d8) = out["bf16"], out["int8"]
    if not np.array_equal(db, d8) or wb.shape != w8.shape:
        raise AssertionError(f"int8 vs bf16: durations {d8} vs {db}, wav shapes "
                             f"{w8.shape} vs {wb.shape}")
    rel = rel_l2(w8, wb)
    lo, hi = INT8_WAV_REL_L2
    log(f"  int8 vs bf16 on the card: durations bit-equal {d8}, wav relative L2 "
        f"{rel:.6f} (band [{lo:g}, {hi:g}])")
    from supertonic_tpu_torch.utils.audio_metrics import log_mel_snr, mcd

    for i, d in enumerate(db):  # each row over its own audio
        n = int(cfg.sample_rate * float(d))
        log(f"  int8 vs bf16 row {i} ({len(texts[i])} chars, {n} samples): log-mel SNR "
            f"{log_mel_snr(wb[i, :n], w8[i, :n], cfg.sample_rate):.3f} dB, MCD "
            f"{mcd(wb[i, :n], w8[i, :n], cfg.sample_rate):.4f} dB (readings; {smi})")
    if not lo <= rel <= hi:
        raise AssertionError("int8 whole path: wav outside the band around bf16")


def fused_projections_path(params) -> None:
    """One b64/5-step batch with fused projections (``fuse_projections``)
    against the unfused tree, injected noise, in bf16 and in int8 (where the
    fused tree is quantized at init); the fused batch's launches are
    counted, and in int8 their number shows the fused route."""
    cfg, proc, texts, style, noise = whole_path_inputs(64)
    trees = (("unfused", params), ("fused", fuse_projections(params)))
    for precision in ("bf16", "int8"):
        out = {}
        for tree_name, tree in trees:
            eng = SynthesisEngine(tree, cfg, proc, precision=precision)
            # the first call captures the text and acoustic programs (their
            # eager runs count too); the counted call replays them
            eng.infer_batch(texts, ["en"] * 64, style, total_step=5, noise=noise)
            ops.reset_launch_counts()
            out[tree_name] = eng.infer_batch(texts, ["en"] * 64, style, total_step=5,
                                             noise=noise)
            counts = ops.launch_counts()
        per_batch = dict(PER_BATCH[precision])
        per_batch.update(FUSED_INT8 if precision == "int8" else FUSED_BF16)
        check_launches(counts, per_batch, 1, f"one fused b64/5-step {precision} batch")
        if precision == "int8" and counts["w8a8_matmul"] != FUSED_W8A8_LINEARS:
            raise AssertionError("fused int8 batch did not take the fused projections")
        (w, d), (wf, df) = out["unfused"], out["fused"]
        if wf.shape != w.shape or not np.isfinite(wf).all():
            raise AssertionError(f"fused {precision}: wav shape {wf.shape} vs {w.shape}")
        dur_rel = float(np.max(np.abs(df - d) / np.abs(d)))
        rel = rel_l2(wf, w)
        log(f"  fused vs unfused projections, b64/5-step {precision}: bit-equal "
            f"{np.array_equal(wf, w) and np.array_equal(df, d)}, duration rel diff "
            f"{dur_rel:.3e}, wav relative L2 {rel:.3e} (limit {FUSED_WAV_REL_L2_MAX:g})")
        if dur_rel > 1e-2 or rel > FUSED_WAV_REL_L2_MAX:
            raise AssertionError(f"fused {precision}: far from the unfused batch")


# ---------------------------------------------------------------------------
# the compiled programs: CUDA graphs captured per static shape
# ---------------------------------------------------------------------------

# the hand-written kernels' names in a device trace, one per wrapper launch
# (bf16 and f32 designs; the FFN's LayerNorm pass, the W8A8 product's
# rescale-and-bias epilogue, the int32 product's epilogue)
TRACE_NAMES = {"attention": ("attn_rows", "attn_wgmma", "attn_wide"),
               "adaln_ffn": ("ln_mod", "ffn_up_f32"),
               "resblock_chain": ("chain_wgmma", "chain_kernel", "conv_pass"),
               "int8_matmul": ("Int32Out",),
               "w8a8_matmul": ("ScaleOut", "w8a8_wgmma", "w8a8_simt"),
               "quantize": ("quantize_rows", "quantize_long_rows"),
               "ln_modulate": ("layer_norm_rows",), "bias_rope": ("rope_pairs",),
               "gated_residual": ("gated_residual_pass",),
               "conv1d": ("conv_wgmma", "conv_simt"), "linear": ("linear_wgmma", "linear_simt")}
# host calls that launch device work: kernels and graphs
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")
# a library's matrix products in a device trace (cuBLAS's kernel names:
# sm90_xmma_gemm_..., nvjet_..., cutlass's), and the port's own GEMM kernels
# whose names hold "gemm", as whole template names (stk::wgmma_gemm<...>,
# mma_gemm<...>, or mangled 10wgmma_gemmI...): cuBLAS's xmma_gemm_ is not one
LIBRARY_PRODUCTS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")
OWN_GEMMS = re.compile(r"(?<![A-Za-z_])(?:wgmma_gemm|mma_gemm)[<I]")
MAX_HOST_LAUNCHES = 32  # per replayed b64/5-step batch
DEVICE_BUSY_MS: dict = {}  # precision -> device busy of its main engine's traced replayed batch
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def library_product(name: str) -> bool:
    """Whether a kernel name of a device trace is a library's matrix product
    (and not one of the port's own GEMM kernels)."""
    return any(n in name for n in LIBRARY_PRODUCTS) and not OWN_GEMMS.search(name)


def hold_bit_equal(what: str, got, want) -> None:
    """Each output of a replay bit-equal to the eager function's."""
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        view = BITS.get(w.dtype, w.dtype)
        same = (g.dtype == w.dtype and g.shape == w.shape
                and torch.equal(g.view(view), w.view(view)))
        err = float((g.float() - w.float()).abs().max()) if g.shape == w.shape else None
        log(f"  {what}: output {i} {tuple(w.shape)} {w.dtype} bit-equal {same} "
            f"(max abs err {err})")
        if not same:
            raise AssertionError(f"{what}: the replay differs from the eager function")


def fused_replay_vs_eager(eng, texts, style, seed: int = 77) -> None:
    """The fused program at the cell's shape (the engine's egress, the key
    the cell replays, and f32 egress) against synthesize_fused run eagerly,
    with generators of one seed."""
    pend = eng.infer_batch_begin(texts, ["en"] * len(texts), style.tile(len(texts)), 5,
                                 device_output=True)
    eng.infer_batch_end(pend)
    speed = eng._speed(1.05)
    for egress in (eng.egress_format, "f32"):
        kw = dict(precision=eng.precision, egress=egress)
        with torch.inference_mode():
            got = eng.programs.synthesize_fused(
                eng.params, eng.cfg, *pend.dev_args, torch.Generator(device=DEV).manual_seed(seed),
                speed, 5, pend.t_bucket, **kw)
            want = synthesis.synthesize_fused(
                eng.params, eng.cfg, *pend.dev_args, torch.Generator(device=DEV).manual_seed(seed),
                speed, 5, pend.t_bucket, **kw)
        hold_bit_equal(f"fused program b{len(texts)}/5-step T={pend.t_bucket} {eng.precision} "
                       f"{egress} egress, replay vs eager", got, want)
    # speed as a 0-dim tensor (a true division, as in XLA) against the
    # Python float of the trees before (a product with the reciprocal)
    cfg = eng.cfg
    with torch.inference_mode():
        durs = [synthesis.text_stage(eng.params, cfg, *pend.dev_args, sp,
                                     precision=eng.precision)[0] for sp in (1.05, speed)]
    lat = [torch.ceil(d * cfg.sample_rate / cfg.chunk_size) for d in durs]
    log(f"  duration / speed, b{len(texts)}: {int((durs[0] != durs[1]).sum())} of "
        f"{durs[0].numel()} durations differ between a float and a tensor speed (max abs "
        f"{float((durs[0] - durs[1]).abs().max()):.3e} s), {int((lat[0] != lat[1]).sum())} "
        f"latent lengths")


def trace_replayed_batch(tts, texts, style, per_batch, wall_s: float) -> None:
    """One b64/5-step batch, a replay of its program, under torch.profiler:
    the host calls that launch device work, the hand-written kernels found
    in the device trace (one per wrapper launch: the per-batch counts), and
    device busy against the wall of the unprofiled reps (the idle share)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's first start-up, outside the window
        torch.cuda.synchronize()
    n_programs = len(tts.engine.programs.stats())
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        tts.synthesize_batch(texts, ["en"] * len(texts), style.tile(len(texts)), total_step=5)
        torch.cuda.synchronize()
    if len(tts.engine.programs.stats()) != n_programs:
        raise AssertionError("the profiled batch captured a new program")
    events = prof.key_averages()
    host = {e.key: e.count for e in events if e.device_type.name == "CPU"
            and (e.key.startswith(HOST_LAUNCH_CALLS) or "Memcpy" in e.key
                 or "Event" in e.key)}
    n_launch = sum(n for k, n in host.items() if k.startswith(HOST_LAUNCH_CALLS))
    dev = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    found = {k: sum(e.count for e in dev if any(n in e.key for n in TRACE_NAMES[k]))
             for k in per_batch}
    library = {e.key[:80]: e.count for e in dev if library_product(e.key)}
    log(f"  replayed b64/5-step batch under torch.profiler: {n_launch} host launch calls "
        f"(limit {MAX_HOST_LAUNCHES}); host calls {dict(sorted(host.items()))}")
    precision = tts.engine.precision
    DEVICE_BUSY_MS.setdefault(precision, busy)  # the first engine of each precision
    beside = ("" if precision == "bf16" or "bf16" not in DEVICE_BUSY_MS else
              f" (bf16, phase 3: {DEVICE_BUSY_MS['bf16']:.1f} ms; {precision} - bf16 = "
              f"{busy - DEVICE_BUSY_MS['bf16']:+.1f} ms)")
    log(f"  hand-written kernels in its device trace: {found}; device busy {busy:.1f} ms"
        f"{beside} in {sum(e.count for e in dev)} device events; unprofiled wall "
        f"{wall_s * 1e3:.1f} ms (median of the reps), idle share "
        f"{max(0.0, 1 - busy / (wall_s * 1e3)):.3f}")
    n_graphs = sum(n for k, n in host.items() if k.startswith(HOST_LAUNCH_CALLS[2:]))
    if n_launch > MAX_HOST_LAUNCHES or n_graphs < 1:
        raise AssertionError(f"one replayed batch: {n_launch} host launch calls, {n_graphs} "
                             f"of them graph launches")
    # in bf16 every product of the batch is a hand-written kernel
    log(f"  library matrix products in its device trace: {library or 'none'}")
    if found != per_batch:
        raise AssertionError(f"the replayed batch's trace holds {found}, expected {per_batch}")
    if precision == "bf16" and library:
        raise AssertionError(f"the replayed bf16 batch ran library products: {library}")


def log_programs(eng, what: str) -> None:
    """Capture seconds and memory of each program the engine captured."""
    stats = eng.programs.stats()
    for st in stats:
        log(f"    program {st['key']}: capture {st['capture_s']:.3f}s, pool "
            f"+{st['pool_bytes'] / 2**20:.1f} MiB, static inputs "
            f"{st['static_bytes'] / 2**20:.3f} MiB")
    log(f"  {what}: {len(stats)} programs, pool growth "
        f"{sum(st['pool_bytes'] for st in stats) / 2**30:.3f} GiB in all; device memory "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB, the process's peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def programs_check(params) -> None:
    """Phase 8: in f32 and bf16, a fused batch of the three protocol texts
    (B bucket 4, T=448), the B=1 flow of the long text with the halo padding
    and its first, second and last vocoder windows: each program's replay
    bit-equal to the eager function with generators of one seed."""
    from supertonic_tpu_torch.models.vocoder import receptive_field_frames

    cfg, proc, texts, style, _noise = whole_path_inputs()
    halo, w, t_pad = receptive_field_frames(cfg), WINDOW_FRAMES, 448
    for precision in ("f32", "bf16"):
        eng = SynthesisEngine(params, cfg, proc, precision=precision)
        speed = eng._speed(1.05)
        with torch.inference_mode():
            dev3, *_ = eng._prepare_inputs(texts, ["en"] * 3, style)
            dev1, *_ = eng._prepare_inputs([LONG_TEXT], ["en"], style.take(slice(0, 1)))
            for egress in ("int16", "f32"):
                kw = dict(precision=precision, egress=egress)
                got = eng.programs.synthesize_fused(
                    eng.params, cfg, *dev3, torch.Generator(device=DEV).manual_seed(3), speed,
                    5, t_pad, **kw)
                want = synthesis.synthesize_fused(
                    eng.params, cfg, *dev3, torch.Generator(device=DEV).manual_seed(3), speed,
                    5, t_pad, **kw)
                hold_bit_equal(f"fused program b{dev3[0].shape[0]} T={t_pad} {precision} "
                               f"{egress} egress", got, want)
            got = eng.programs.flow_fused(
                eng.params, cfg, *dev1, torch.Generator(device=DEV).manual_seed(4), speed, 5,
                t_pad, precision=precision, halo=halo)
            want = synthesis.flow_fused(
                eng.params, cfg, *dev1, torch.Generator(device=DEV).manual_seed(4), speed, 5,
                t_pad, precision=precision, halo=halo)
            hold_bit_equal(f"flow program B1 T={t_pad} + 2 x {halo} halo {precision}", got, want)
            xt_pad, _dur, m_pad = want
            for start in (0, w, t_pad - w):
                kw = dict(precision=precision, egress="f32")
                got = eng.programs.vocode_window(eng.params, cfg, xt_pad, m_pad, start, w, halo,
                                                 **kw)
                want = synthesis.vocode_window(eng.params, cfg, xt_pad, m_pad, start, w, halo,
                                               **kw)
                hold_bit_equal(f"window program B1 start {start} {precision}", (got,), (want,))
        log_programs(eng, f"the {precision} engine of phase 8")
        del eng


# ---------------------------------------------------------------------------
# phase 9: the graph bundle (the ONNX executor backend)
# ---------------------------------------------------------------------------

GRAPH_DUR_RTOL = 1e-5   # f32 graphs vs the native f32 engine, durations
GRAPH_WAV_ATOL = 1e-4   # f32 graphs vs native, card vs CPU, adapter vs fused


def graph_vs(what: str, got, want, interior: int | None = None) -> None:
    """Durations within GRAPH_DUR_RTOL with the same latent lengths; wav
    within GRAPH_WAV_ATOL over each row's audio, int(sr * duration) samples
    (the samples a caller keeps; past them the two vocoders mask the bucket
    padding at different points), and over the first ``interior`` samples
    if given."""
    (gw, gd), (ww, wd) = got, want
    cfg = TTSConfig()
    lat = lambda d: ((d * cfg.sample_rate).astype(np.int64) + cfg.chunk_size - 1) \
        // cfg.chunk_size  # noqa: E731
    dur_rel = float(np.max(np.abs(gd - wd) / np.abs(wd)))
    same_lat = bool(np.array_equal(lat(gd), lat(wd)))
    wav_err, n_cmp = 0.0, 0
    for i in range(len(wd)):
        n = min(int(cfg.sample_rate * float(wd[i])), gw.shape[1], ww.shape[1],
                interior if interior is not None else gw.shape[1])
        wav_err = max(wav_err, float(np.max(np.abs(gw[i, :n] - ww[i, :n]))))
        n_cmp += n
    log(f"  {what}: duration max rel diff {dur_rel:.3e} (rtol {GRAPH_DUR_RTOL:g}), same "
        f"latent lengths {same_lat} {lat(gd).tolist()}, wav max abs diff {wav_err:.3e} over "
        f"{n_cmp} samples (atol {GRAPH_WAV_ATOL:g}; wav shapes {gw.shape} / {ww.shape})")
    if dur_rel > GRAPH_DUR_RTOL or not same_lat or wav_err > GRAPH_WAV_ATOL:
        raise AssertionError(f"{what}: disagree")


def graph_bundle(params, bf16_rates) -> None:
    """Phase 9: the smoke params exported as a four-graph bundle by the
    port's exporter, then (a) the automap round trip bit-equal; (b)
    TTS(<bundle>) in f32 (strict f32 products, no bf16 storage) against the
    native f32 engine on the same params and injected noise at B=4; (c) the
    graph backend card vs CPU in f32; (d) a replayed fused batch of the
    graph backend bit-equal to its eager run, and its host launch calls
    under torch.profiler; (e) the per-call adapter against the fused
    backend in f32; (f) b64 audio-sec/s of TTS(<bundle>) at "default"
    precision with bf16 storage beside phase 3's native bf16, and each
    program's capture seconds and pool growth."""
    from supertonic_tpu_torch.assets import flatten_tree
    from supertonic_tpu_torch.assets.automap import automap_bundle
    from supertonic_tpu_torch.assets.onnx_export import export_bundle
    from supertonic_tpu_torch.models.vocoder import receptive_field_frames

    cfg = TTSConfig()
    bundle = os.path.join(OUT_DIR, "graph_bundle")
    shutil.rmtree(bundle, ignore_errors=True)
    t0 = time.perf_counter()
    export_bundle(params, cfg, bundle, indexer=build_default_indexer())
    sizes = {f: os.path.getsize(os.path.join(bundle, f)) for f in sorted(os.listdir(bundle))
             if f.endswith(".onnx")}
    log(f"  exported the 66M params as four graphs in {time.perf_counter() - t0:.2f}s: "
        + ", ".join(f"{f} {n / 2**20:.1f} MiB" for f, n in sizes.items()))
    for var in ("TTS_ONNX_FUSED", "TTS_ONNX_BF16"):
        os.environ.pop(var, None)

    # (a)
    t0 = time.perf_counter()
    got, reports = automap_bundle(bundle, cfg)
    want, mapped = flatten_tree(params), flatten_tree(got)
    bad = [k for k in want if k not in mapped or not np.array_equal(mapped[k], want[k])]
    log(f"  (a) automap round trip in {time.perf_counter() - t0:.2f}s: {len(mapped)} params "
        f"of {len(want)} mapped, {len(bad)} differ; "
        + ", ".join(f"{m} {r['matched_params']} params / {r['consts_checked']} consts"
                    for m, r in reports.items()))
    if bad or set(mapped) != set(want):
        raise AssertionError(f"automap round trip: {bad[:5]}")

    # (b) and (c): injected noise, f32
    fresh_rate_dir("graph-f32")
    _cfg, proc, texts, style, noise = whole_path_inputs(4)
    t0 = time.perf_counter()
    tts = TTS(bundle, precision="f32")
    eng = tts.engine
    if eng.backend is None or eng.programs is None:
        raise AssertionError("TTS(<bundle>) did not serve the fused graph backend on the card")
    log(f"  TTS(<bundle>, precision='f32') on {eng.device}: fused graph backend, load "
        f"{time.perf_counter() - t0:.2f}s, matmul precision "
        f"{eng.backend.execs['vector_estimator']._matmul_precision}, bf16 storage "
        f"{eng.backend.execs['vector_estimator']._bf16_storage}")
    graph = eng.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
    native = SynthesisEngine(params, cfg, proc, precision="f32").infer_batch(
        texts, ["en"] * 4, style, total_step=2, noise=noise)
    graph_vs("(b) graph backend vs native engine, f32, B=4, injected noise", graph, native)
    t0 = time.perf_counter()
    cpu = TTS(bundle, precision="f32", device="cpu").engine.infer_batch(
        texts, ["en"] * 4, style, total_step=2, noise=noise)
    log(f"  graph backend f32 on the CPU: {time.perf_counter() - t0:.2f}s")
    graph_vs("(c) graph backend card vs CPU, f32", graph, cpu)

    # (d): a replayed fused batch against its eager run, and its host launches
    pend = eng.infer_batch_begin(texts, ["en"] * 4, style, 5, device_output=True)
    eng.infer_batch_end(pend)
    speed = eng._speed(1.05)
    with torch.inference_mode():
        for egress in ("int16", "f32"):
            got = eng.programs.synthesize_fused(
                eng.params, cfg, *pend.dev_args, torch.Generator(device=DEV).manual_seed(5),
                speed, 5, pend.t_bucket, precision=eng.precision, egress=egress,
                backend=eng.backend)
            want = eng.backend.fused_fn(
                eng.params, *pend.dev_args, torch.Generator(device=DEV).manual_seed(5),
                speed, 5, pend.t_bucket, egress)
            hold_bit_equal(f"(d) graph fused program b{pend.dev_args[0].shape[0]} "
                           f"T={pend.t_bucket} f32 {egress} egress, replay vs eager", got, want)
    trace_graph_batch(tts, texts, style)

    # (e): the per-call adapter against the fused backend, f32
    os.environ["TTS_ONNX_FUSED"] = "0"
    try:
        adapter = TTS(bundle, precision="f32").engine
    finally:
        del os.environ["TTS_ONNX_FUSED"]
    if adapter.__class__.__name__ != "OnnxEngineAdapter":
        raise AssertionError(f"TTS_ONNX_FUSED=0 gave {adapter.__class__.__name__}")
    # the engine zero-fills injected noise past its frames; the pipeline
    # takes it channel-first, covering the latent
    t_max = int(np.max(((graph[1] * cfg.sample_rate).astype(np.int64) + cfg.chunk_size - 1)
                       // cfg.chunk_size))
    noise_cf = np.zeros((4, cfg.latent_channels, max(t_max, noise.shape[1])), np.float32)
    noise_cf[:, :, :noise.shape[1]] = noise.transpose(0, 2, 1)
    per_call = adapter.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise_cf)
    # the adapter runs the reference's orchestration: its vocoder sees the
    # bucket padding unmasked, which reaches back one receptive field from
    # the longest row's end; the samples before that are the same function
    interior = (t_max - receptive_field_frames(cfg)) * cfg.chunk_size
    graph_vs("(e) per-call adapter vs fused graph backend, f32", per_call, graph, interior)
    del tts, eng, adapter

    # (f): throughput at "default" precision with bf16 storage, from the
    # rate phase 3 learned, so the batches run at the native cell's buckets
    os.environ["TTS_RATE_CACHE_DIR"] = os.path.join(OUT_DIR, "rates", "main-bf16")
    t0 = time.perf_counter()
    tts = TTS(bundle)
    vex = tts.engine.backend.execs["vector_estimator"]
    log(f"  TTS(<bundle>) bf16: matmul precision {vex._matmul_precision}, bf16 storage "
        f"{vex._bf16_storage}, load {time.perf_counter() - t0:.2f}s")
    style1 = tts.get_voice_style("M1")
    texts64 = [TEXTS[i % 3] for i in range(64)]
    for steps in (5, 2):
        tts.synthesize_batch(texts64, ["en"] * 64, style1.tile(64), total_step=steps)
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w, d = tts.synthesize_batch(texts64, ["en"] * 64, style1.tile(64), total_step=steps)
            wall = time.perf_counter() - t0
            for i in range(3):
                check_audio(w[i], float(d[i]), tts.sample_rate, f"graph b64 row {i}")
            log(f"  (f) graph backend b64/{steps}-step rep {rep}: {float(d.sum()):.3f}s audio in "
                f"{wall:.4f}s = {float(d.sum()) / wall:.2f} audio-sec/s (native bf16, phase 3: "
                f"{' / '.join(f'{r:.2f}' for r in bf16_rates[steps])})")
    trace_graph_batch(tts, texts64, style1.tile(64))
    log_programs(tts.engine, "(f) the graph backend's bf16 engine")


def trace_graph_batch(tts, texts, style) -> None:
    """One replayed graph-backend batch under torch.profiler: its host
    calls that launch device work (at most MAX_HOST_LAUNCHES, one of them a
    graph launch), its device busy time and its largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    eng = tts.engine
    n = len(texts)
    tts.synthesize_batch(texts, ["en"] * n, style, total_step=5)  # its key, captured
    n_programs = len(eng.programs.stats())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        tts.synthesize_batch(texts, ["en"] * n, style, total_step=5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(eng.programs.stats()) != n_programs:
        raise AssertionError("the profiled graph batch captured a new program")
    events = prof.key_averages()
    host = {e.key: e.count for e in events if e.device_type.name == "CPU"
            and e.key.startswith(HOST_LAUNCH_CALLS)}
    n_launch = sum(host.values())
    n_graphs = sum(n for k, n in host.items() if k.startswith(HOST_LAUNCH_CALLS[2:]))
    dev = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"  replayed graph-backend b{n}/5-step batch under torch.profiler: {n_launch} host "
        f"launch calls (limit {MAX_HOST_LAUNCHES}) {dict(sorted(host.items()))}; device busy "
        f"{busy:.1f} ms in {sum(e.count for e in dev)} device events, profiled wall "
        f"{wall * 1e3:.1f} ms; largest: " + "; ".join(
            f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms" for e in top))
    if n_launch > MAX_HOST_LAUNCHES or n_graphs < 1:
        raise AssertionError(f"a replayed graph batch: {n_launch} host launch calls, "
                             f"{n_graphs} graph launches")


# ---------------------------------------------------------------------------
# phase 3, second engine: the JAX default's unfused AdaLN FFN
# ---------------------------------------------------------------------------

def unfused_ffn_cell(assets, rates, smi: str) -> None:
    """The b64 cell through SynthesisEngine(fused_ffn=False), the JAX
    engine's default (the AdaLN FFN as linear, silu, linear: cuBLAS
    products), at the rate phase 3 learned: the launches of one replayed
    b64/5-step batch, b64 audio-sec/s at 5 and 2 steps beside the default's
    from the same process, and the bf16 wav distance between the two
    settings on the same injected noise."""
    tts = TTS(assets)
    a = tts.assets
    tts.engine = SynthesisEngine(a.params, tts.cfg, a.processor, fused_ffn=False)
    if tts.engine.fused_ffn:
        raise AssertionError("fused_ffn=False did not reach the engine")
    style = tts.get_voice_style("M1")
    texts = [TEXTS[i % 3] for i in range(64)]
    walls = []
    for steps in (5, 2):
        tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=steps)
        if steps == 5:
            shapes, one = recorded(tts.engine, lambda: tts.synthesize_batch(
                texts, ["en"] * 64, style.tile(64), total_step=5))
            log(f"  fused_ffn=False: shapes given to each kernel in one b64/5-step batch: "
                f"{shapes}")
            check_exact(one, PER_BATCH["bf16 unfused FFN"],
                        "one b64/5-step batch with fused_ffn=False (a replay)")
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _w, d = tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=steps)
            wall = time.perf_counter() - t0
            if steps == 5:
                walls.append(wall)
            log(f"  fused_ffn=False bf16 b64/{steps}-step rep {rep}: {float(d.sum()):.3f}s "
                f"audio in {wall:.4f}s = {float(d.sum()) / wall:.2f} audio-sec/s (fused_ffn="
                f"True, phase 3: {' / '.join(f'{r:.2f}' for r in rates[steps])}; {smi})")
    trace_replayed_batch(tts, texts, style, PER_BATCH["bf16 unfused FFN"],
                         float(np.median(walls)))
    log_programs(tts.engine, "the fused_ffn=False engine")
    cfg, proc, texts64, style64, noise = whole_path_inputs(64)
    out = {}
    for fused in (True, False):
        eng = SynthesisEngine(a.params, cfg, proc, fused_ffn=fused)
        out[fused] = eng.infer_batch(texts64, ["en"] * 64, style64, total_step=5, noise=noise)
        del eng
    (wf, df), (wu, du) = out[True], out[False]
    if not np.array_equal(df, du) or wf.shape != wu.shape:
        raise AssertionError("fused_ffn: the text stage differs between the settings")
    from supertonic_tpu_torch.utils.audio_metrics import log_mel_snr, mcd

    log(f"  bf16 b64/5-step, injected noise: fused_ffn=False against True: durations "
        f"bit-equal, wav relative L2 {rel_l2(wu, wf):.6f}, max abs diff "
        f"{float(np.abs(wu - wf).max()):.3e} (readings; {smi})")
    for i in range(3):  # each protocol text over its own audio
        n = int(cfg.sample_rate * float(df[i]))
        log(f"  fused_ffn=False against True, row {i} ({len(texts64[i])} chars): log-mel SNR "
            f"{log_mel_snr(wf[i, :n], wu[i, :n], cfg.sample_rate):.3f} dB, MCD "
            f"{mcd(wf[i, :n], wu[i, :n], cfg.sample_rate):.4f} dB (readings; {smi})")
    del tts


# ---------------------------------------------------------------------------
# phase 3, third engine: the vocoder's chains without the chain kernel
# ---------------------------------------------------------------------------

def unfused_resblocks_cell(assets, rates, smi: str) -> dict:
    """The b64 cell through SynthesisEngine(fused_resblocks=False) (the JAX
    engine's default, TTS_VOC_FUSED unset there): every chain through
    _resblock's torch convs. The launches of one replayed b64/5-step batch
    (no chain), b64/5-step audio-sec/s beside the default's from the same
    process, and, on the same injected noise, the bf16 wav distance to an
    engine built under TTS_VOC_FUSED=0, which must launch no chain either.
    Returns the shapes one replayed batch gave each kernel (phase 5 holds
    the conv kernel at the chains' convs)."""
    tts = TTS(assets)
    a = tts.assets
    tts.engine = SynthesisEngine(a.params, tts.cfg, a.processor, fused_resblocks=False)
    if tts.engine.fused_resblocks:
        raise AssertionError("fused_resblocks=False did not reach the engine")
    style = tts.get_voice_style("M1")
    texts = [TEXTS[i % 3] for i in range(64)]
    tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=5)
    shapes, one = recorded(tts.engine, lambda: tts.synthesize_batch(
        texts, ["en"] * 64, style.tile(64), total_step=5))
    log(f"  fused_resblocks=False: shapes given to each kernel in one b64/5-step batch: "
        f"{shapes}")
    one_batch = shapes
    check_exact(one, PER_BATCH["bf16 unfused resblocks"],
                "one b64/5-step batch with fused_resblocks=False (a replay)")
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _w, d = tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=5)
        wall = time.perf_counter() - t0
        log(f"  fused_resblocks=False bf16 b64/5-step rep {rep}: {float(d.sum()):.3f}s audio "
            f"in {wall:.4f}s = {float(d.sum()) / wall:.2f} audio-sec/s (fused_resblocks=True, "
            f"phase 3: {' / '.join(f'{r:.2f}' for r in rates[5])}; {smi})")
    log_programs(tts.engine, "the fused_resblocks=False engine")
    del tts
    cfg, proc, texts64, style64, noise = whole_path_inputs(64)
    out = {}
    for fused in (True, False):
        if not fused:
            os.environ["TTS_VOC_FUSED"] = "0"
        try:
            eng = SynthesisEngine(a.params, cfg, proc)
        finally:
            os.environ.pop("TTS_VOC_FUSED", None)
        if eng.fused_resblocks != fused:
            raise AssertionError(f"TTS_VOC_FUSED: engine.fused_resblocks is "
                                 f"{eng.fused_resblocks}")
        ops.reset_launch_counts()
        out[fused] = eng.infer_batch(texts64, ["en"] * 64, style64, total_step=5, noise=noise)
        chains = ops.launch_counts()["resblock_chain"]
        log(f"  TTS_VOC_FUSED={'unset' if fused else '0'}: {chains} chain launches over one "
            f"injected-noise b64 batch")
        if (chains == 0) == fused:
            raise AssertionError(f"TTS_VOC_FUSED={'unset' if fused else '0'}: {chains} "
                                 f"chain launches")
        del eng
    (wf, df), (wu, du) = out[True], out[False]
    if not np.array_equal(df, du) or wf.shape != wu.shape:
        raise AssertionError("fused_resblocks: the text stage differs between the settings")
    log(f"  bf16 b64/5-step, injected noise: fused_resblocks=False against True: durations "
        f"bit-equal, wav relative L2 {rel_l2(wu, wf):.6f}, max abs diff "
        f"{float(np.abs(wu - wf).max()):.3e} (readings; {smi})")
    return one_batch


# ---------------------------------------------------------------------------
# phase 12: the whole path at widths off the default config
# ---------------------------------------------------------------------------

PATH_KERNELS = ("attention", "adaln_ffn", "resblock_chain", "ln_modulate", "bias_rope",
                "gated_residual", "conv1d")
ODD_WIDTHS = "odd widths: latent 15, head 15, vocoder (36, 20), resblock k 11, even k 4"


def width_configs() -> list:
    """(name, config) of phase 12: the tests' tiny config's dims; a
    reference-format tts.json with proj_out.idim 384 (the text encoder at
    Dh 96); the vector estimator at Dh 128 with the vocoder's fine
    timelines at 384 and 192 channels; a reference-format tts.json with
    proj_out.idim 1024 (the text encoder at Dh 256) and the vocoder's
    chains at conv size 7, whose pairs reach 30 frames (past the fused
    kernels' 23 in f32: per-conv launches where no fused tile holds them);
    ODD_WIDTHS, the tiny dims with every conv off the conv kernel's earlier
    domain: latent 5 x 3 = 15 channels into the pre conv, a head of 15,
    vocoder channels (36, 20) (up 1's masked fold 36 channels a fine
    frame), resblocks of size 11 at dilations (1, 3, 5) (reaching 50
    frames), even sizes at the up convs (4) and the prenet (4), run with
    both fused_resblocks settings. Depth cut to one block a network (two at
    the tiny dims)."""
    import dataclasses

    from supertonic_tpu_torch import config as C

    style = C.StyleTokenLayerConfig(n_style=4, style_value_dim=16)
    tiny = C.TTSConfig(
        ae=C.AEConfig(sample_rate=16000, base_chunk_size=64),
        ttl=C.TTLConfig(chunk_compress_factor=2, latent_dim=8, proj_out_idim=32,
                        proj_out_odim=64, style=style),
        dp=C.DPConfig(latent_dim=8, chunk_compress_factor=2, style=style),
        text_encoder=C.TextEncoderHParams(vocab_size=256, dim=32, n_layers=2, n_heads=2),
        duration_predictor=C.DurationPredictorHParams(vocab_size=256, dim=32, n_layers=2,
                                                      n_heads=2),
        vector_estimator=C.VectorEstimatorHParams(dim=64, n_layers=2, n_heads=2,
                                                  time_embed_dim=32),
        vocoder=C.VocoderHParams(dim=64, upsample_factors=(4, 4), channels=(32, 16),
                                 resblock_dilations=(1, 3)))

    def shallow(cfg, **kw):
        return dataclasses.replace(
            cfg, text_encoder=dataclasses.replace(cfg.text_encoder, n_layers=1),
            duration_predictor=dataclasses.replace(cfg.duration_predictor, n_layers=1),
            vector_estimator=dataclasses.replace(cfg.vector_estimator, n_layers=1, **kw))

    te96 = shallow(C.tts_config_from_reference_dict(
        {"ttl": {"text_encoder": {"proj_out": {"idim": 384, "odim": 512}}}}))
    ve128 = shallow(C.TTSConfig(), dim=256, n_heads=2)
    ve128 = dataclasses.replace(ve128, vocoder=dataclasses.replace(ve128.vocoder,
                                                                   channels=(384, 192)))
    te256 = shallow(C.tts_config_from_reference_dict(
        {"ttl": {"text_encoder": {"proj_out": {"idim": 1024, "odim": 512}}}}))
    te256 = dataclasses.replace(te256, vocoder=dataclasses.replace(te256.vocoder,
                                                                   resblock_kernel=7))
    odd = dataclasses.replace(
        tiny, ae=dataclasses.replace(tiny.ae, base_chunk_size=80),
        ttl=dataclasses.replace(tiny.ttl, latent_dim=5, chunk_compress_factor=3),
        dp=dataclasses.replace(tiny.dp, latent_dim=5, chunk_compress_factor=3),
        text_encoder=dataclasses.replace(tiny.text_encoder, conv_kernel=4),
        vocoder=dataclasses.replace(tiny.vocoder, channels=(36, 20), resblock_kernel=11,
                                    resblock_dilations=(1, 3, 5), stage_kernel=4))
    return [("tiny dims", tiny), ("tts.json proj_out.idim 384", te96),
            ("VE Dh 128, vocoder channels (384, 192)", ve128),
            ("tts.json proj_out.idim 1024, vocoder conv size 7", te256), (ODD_WIDTHS, odd)]


def expected_widths(cfg, fused_resblocks: bool = True) -> dict:
    """The widths each path kernel must be given at ``cfg``: head widths,
    the VE's (D, F), the chains' channels and dilations, the convs' (Cin,
    Cout, k); without ``fused_resblocks`` no chain, and every resblock conv
    on the conv kernel."""
    heads = {net.dim // net.n_heads for net in (cfg.text_encoder, cfg.duration_predictor,
                                                cfg.vector_estimator)}
    ve = cfg.vector_estimator
    voc = cfg.vocoder
    chains = {c for c in (voc.dim, *voc.channels)
              if c <= vocoder_fused.MAX_CHANNELS and fused_resblocks}
    dims = {net.dim for net in (cfg.text_encoder, cfg.duration_predictor, ve)}
    te = cfg.text_encoder
    convs = {(te.dim, te.dim, te.conv_kernel), (cfg.latent_channels, voc.dim, 7)}
    convs |= {(c, c, voc.resblock_kernel) for c in (voc.dim, *voc.channels)
              if c not in chains}
    cin = voc.dim
    for f, c in zip(voc.upsample_factors, voc.channels):
        convs.add((cin, c * f, voc.stage_kernel))
        cin = c
    convs.add((cin, cfg.chunk_size // int(np.prod(voc.upsample_factors)), 3))
    return {"attention": heads, "adaln_ffn": {(ve.dim, ve.dim * ve.ffn_mult)},
            "resblock_chain": chains, "ln_modulate": dims, "bias_rope": heads,
            "gated_residual": dims, "conv1d": convs}


def launched_widths(tally) -> dict:
    return {"attention": {k[5] for k in tally["attention"]},
            "adaln_ffn": {k[2:] for k in tally["adaln_ffn"]},
            "resblock_chain": {k[2] for k in tally["resblock_chain"]},
            "ln_modulate": {k[2] for k in tally["ln_modulate"]},
            "bias_rope": {k[3] for k in tally["bias_rope"]},
            "gated_residual": {k[2] for k in tally["gated_residual"]},
            "conv1d": {k[2:5] for k in tally["conv1d"]}}


class NoPlainOnCuda:
    """Within, a plain version given a CUDA tensor raises: the wrappers must
    send every CUDA tensor to their kernels."""
    PLAIN = ((attention, "attention_plain"), (ffn, "adaln_ffn_plain"),
             (vocoder_fused, "resblock_chain_plain"), (ln_modulate, "ln_modulate_plain"),
             (rope, "bias_rope_plain"), (gated_residual, "gated_residual_plain"),
             (conv1d, "conv1d_fused_plain"), (linear, "linear_plain"))

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.PLAIN]
        for m, n, fn in self.saved:
            def guarded(*args, _fn=fn, _n=n, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"{_n} was given a CUDA tensor")
                return _fn(*args, **kw)
            setattr(m, n, guarded)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def widths_phase(smi: str) -> dict:
    """Phase 12: at each of width_configs(), TTS(<its assets>) in f32 on the
    card against the same path on the CPU on injected noise (B=2, 2 steps;
    wav atol WHOLE_PATH_WAV_ATOL, durations rtol WHOLE_PATH_DUR_RTOL), then
    TTS() in bf16 through synthesize_batch (finite audio, RMS). Each card
    run must launch attention, the AdaLN FFN, the chain and the block's
    LayerNorm, bias-and-rope and gated-residual kernels at every width its
    config gives them (in bf16 the linear kernel's rope and residual forms
    take the latter two's widths), and no plain version may see a CUDA
    tensor.
    Returns the shapes the card runs gave each kernel, each with the set of
    (dilations, conv size) of the configs that gave it (the chain's), which
    phase 5 holds and times."""
    import dataclasses

    widths = {k: {} for k in ops.KERNELS}
    texts = [SHORT_TEXT, MID_TEXT]
    for i, (name, cfg) in enumerate(width_configs()):
        d = os.path.join(OUT_DIR, "widths", str(i))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "model_config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        save_params(os.path.join(d, "params.npz"), smoke_params(cfg, seed=3))
        noise = np.random.default_rng(5).standard_normal(
            (2, 128, cfg.latent_channels)).astype(np.float32)
        # ODD_WIDTHS with both fused_resblocks settings, its bf16 run with
        # the setting that sends every resblock conv to the conv kernel
        for fused in (True, False) if name == ODD_WIDTHS else (True,):
            what = name if fused else f"{name}, fused_resblocks=False"
            widths_one(what, d, i, cfg, fused, texts, noise, widths, smi,
                       bf16=name != ODD_WIDTHS or not fused)
    return widths


def widths_one(name, d, i, cfg, fused, texts, noise, widths, smi, bf16=True) -> None:
    """Phase 12 at one config and fused_resblocks setting (TTS_VOC_FUSED
    around each engine's construction): f32 card against CPU, then (with
    ``bf16``) bf16; adds the card runs' shapes to ``widths``."""
    want = expected_widths(cfg, fused)
    required = [k for k in PATH_KERNELS if fused or k != "resblock_chain"]

    def tts_at(*args, **kw):
        if not fused:
            os.environ["TTS_VOC_FUSED"] = "0"
        try:
            tts = TTS(*args, **kw)
        finally:
            os.environ.pop("TTS_VOC_FUSED", None)
        if tts.engine.fused_resblocks != fused:
            raise AssertionError(f"{name}: engine.fused_resblocks is "
                                 f"{tts.engine.fused_resblocks}")
        return tts

    def keep(tally):
        for kernel in (*PATH_KERNELS, "linear"):
            for shape in tally[kernel]:
                widths[kernel].setdefault(shape, set()).add(
                    (cfg.vocoder.resblock_dilations, cfg.vocoder.resblock_kernel))

    tag = "" if fused else "-unfused"
    out = {}
    for dev in ("cuda", "cpu"):
        fresh_rate_dir(f"widths-{i}{tag}-{dev}")
        tts = tts_at(d, precision="f32", device=dev)
        style = tts.get_voice_style("M1").tile(2)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with NoPlainOnCuda(), ops.record_launches() as tally:
            out[dev] = tts.engine.infer_batch(texts, ["en", "en"], style, total_step=2,
                                              noise=noise)
        wall = time.perf_counter() - t0
        if dev == "cuda":
            counts = {k: ops.launch_counts()[k] for k in PATH_KERNELS}
            got = launched_widths(tally)
            log(f"  {name}: f32 on the card in {wall:.2f}s, launches {counts}, widths {got}")
            if got != want or not all(counts[k] for k in required):
                raise AssertionError(f"{name}: f32 launched widths {got}, expected {want}")
            keep(tally)
        del tts
    (wg, dg), (wc, dc) = out["cuda"], out["cpu"]
    if wg.shape != wc.shape:
        raise AssertionError(f"{name}: wav shapes differ: {wg.shape} vs {wc.shape}")
    wav_err = float(np.max(np.abs(wg - wc)))
    dur_rel = float(np.max(np.abs(dg - dc) / np.abs(dc)))
    rms = float(np.sqrt(np.mean(np.square(wc))))
    log(f"  {name}: f32 card vs CPU: max wav diff {wav_err:.3e} (atol "
        f"{WHOLE_PATH_WAV_ATOL:g}; wav RMS {rms:.4f}), duration rel diff {dur_rel:.3e}")
    if wav_err > WHOLE_PATH_WAV_ATOL or dur_rel > WHOLE_PATH_DUR_RTOL or rms <= 0.005:
        raise AssertionError(f"{name}: f32 whole path: card and CPU disagree")
    if not bf16:
        return
    fresh_rate_dir(f"widths-{i}{tag}-bf16")
    tts = tts_at(d)
    style = tts.get_voice_style("M1").tile(2)
    with NoPlainOnCuda(), ops.record_launches() as tally:
        wavs, durs = tts.synthesize_batch(texts, ["en", "en"], style, total_step=2)
        torch.cuda.synchronize()
    # in bf16 the rotation and the gated residual run in the linear kernel's
    # epilogue: its rope forms at every head width, its residual forms at
    # every model width
    got = launched_widths(tally)
    epi = {"rope": {key[4] for key in tally["linear"] if key[3] == "rope"},
           "residual": {key[2] for key in tally["linear"] if key[3] == "residual"}}
    if (got != {**want, **dict.fromkeys(EPILOGUE_KERNELS, set())}
            or epi != {"rope": want["bias_rope"], "residual": want["gated_residual"]}):
        raise AssertionError(f"{name}: bf16 launched widths {got}, the linear's rope head "
                             f"widths and residual widths {epi}, expected {want}")
    # the linear kernel (bf16 alone) in each form, in_proj at the latent width
    # and out_proj's tail at it
    ve, c_lat = cfg.vector_estimator, cfg.latent_channels
    forms = {(key[1], key[2], key[3]) for key in tally["linear"]}
    need = {(c_lat, ve.dim, "bias"), (ve.dim, c_lat, "tail"), (ve.time_embed_dim, ve.dim, "silu")}
    if not need <= forms:
        raise AssertionError(f"{name}: bf16 linear launches (K, N, form) {sorted(forms)} lack "
                             f"{sorted(need - forms)}")
    for w, dur in zip(wavs, durs):
        check_audio(w, float(dur), tts.sample_rate, f"{name} bf16")
    log(f"  {name}: bf16 synthesize_batch B=2: {[f'{float(x):.3f}' for x in durs]} s of "
        f"audio, finite, RMS > 0.005; widths {got}, the linear's epilogues {epi}; linear (K, "
        f"N, form) {sorted(forms)} ({smi})")
    keep(tally)
    del tts


# ---------------------------------------------------------------------------
# phase 10: the rest of the single-card surface
# ---------------------------------------------------------------------------

PROGRESS_MAX_HOST_LAUNCHES = 32   # kernel and graph launches of one progress call
NATIVE_FUZZ = 200                 # seeded random texts through the native frontend
UP_MATMUL_F32_ATOL = 1e-4         # up_matmul vs the conv path, f32, b64
RUN_F32_TOL = 1e-4                # compat run_* card vs CPU in f32 (atol = rtol)


def host_launches(prof) -> tuple[int, int, int]:
    """(kernel and graph launch calls, graph launches, memcpy calls) of a
    torch.profiler run on the host."""
    ev = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    n_launch = sum(e.count for e in ev if e.key.startswith(HOST_LAUNCH_CALLS))
    n_graph = sum(e.count for e in ev if e.key.startswith(HOST_LAUNCH_CALLS[2:]))
    n_copy = sum(e.count for e in ev if e.key.startswith("cudaMemcpy"))
    return n_launch, n_graph, n_copy


def eager_twin(params, cfg, proc, **kw):
    """An engine on the card with no programs: every call eager."""
    eng = SynthesisEngine(params, cfg, proc, **kw)
    eng.programs, eng._synth = None, synthesis
    return eng


def compat_surface(assets, smi: str) -> None:
    """load_text_to_speech on the smoke params: __call__ and batch on the
    card, each run_* card against CPU in f32, the ONNX probe on phase 9's
    bundle (the per-call pipeline on the card)."""
    from supertonic_tpu_torch import compat
    from supertonic_tpu_torch.assets import save_voice_style, synthesize_default_styles
    from supertonic_tpu_torch.assets.onnx_pipeline import OnnxPipeline

    cfg = TTSConfig()
    sdir = os.path.join(OUT_DIR, "styles")
    os.makedirs(sdir, exist_ok=True)
    paths = []
    for name, st in synthesize_default_styles(cfg).items():
        if name in ("M1", "F1"):
            paths.append(os.path.join(sdir, f"{name}.json"))
            save_voice_style(paths[-1], st)
    t0 = time.perf_counter()
    tts = compat.load_text_to_speech(assets)
    log(f"  compat.load_text_to_speech(<smoke params>) on {tts.engine.device}, "
        f"{tts.engine.precision}, load {time.perf_counter() - t0:.2f}s")
    one, two = compat.load_voice_style(paths[:1]), compat.load_voice_style(paths)
    wav, dur = tts(MID_TEXT, "en", one, 5)
    check_audio(wav[0], float(dur[0]), tts.sample_rate, "compat __call__")
    wavs, durs = tts.batch([SHORT_TEXT, LONG_TEXT], ["en", "en"], two, 5)
    for i in range(2):
        check_audio(wavs[i], float(durs[i]), tts.sample_rate, f"compat batch row {i}")
    log(f"  compat __call__ {float(dur[0]):.3f}s and batch {durs.round(3).tolist()}s of "
        f"audio: finite, of the durations' length, RMS > 0.005")
    cpu = compat.load_text_to_speech(assets, device="cpu")
    ids, mask = compat.UnicodeProcessor(build_default_indexer())([MID_TEXT], ["en"])
    rng = np.random.default_rng(11)
    noisy = rng.standard_normal((1, cfg.latent_channels, 64)).astype(np.float32)
    lat_mask = np.ones((1, 1, 64), np.float32)
    got = {}
    for dev, t in (("cuda", tts), ("cpu", cpu)):
        t0 = time.perf_counter()
        d = t.run_duration_predictor(ids, one.dp, mask)
        emb = t.run_text_encoder(ids, one.ttl, mask)
        x = t.run_vector_estimator(noisy, emb, one.ttl, mask, lat_mask,
                                   np.zeros(1, np.float32), np.full(1, 5.0, np.float32))
        got[dev] = dict(duration_predictor=d, text_encoder=emb, vector_estimator=x,
                        vocoder=t.run_vocoder(x))
        log(f"  compat run_* on {dev} (f32): {time.perf_counter() - t0:.2f}s")
    for name, want in got["cpu"].items():
        g = got["cuda"][name]
        err = float(np.abs(g - want).max())
        worst = float((np.abs(g - want) / (RUN_F32_TOL + RUN_F32_TOL * np.abs(want))).max())
        log(f"  compat run_{name} card vs CPU f32 {tuple(g.shape)}: max abs diff "
            f"{err:.3e} (atol = rtol = "
            f"{RUN_F32_TOL:g}, worst/limit {worst:.3f})")
        if g.shape != want.shape or worst > 1.0:
            raise AssertionError(f"compat run_{name}: card and CPU disagree")
    del cpu
    bundle = os.path.join(OUT_DIR, "graph_bundle")
    t0 = time.perf_counter()
    pipe = compat.load_text_to_speech(bundle)
    if not isinstance(pipe, OnnxPipeline):
        raise AssertionError(f"the ONNX probe gave {type(pipe).__name__}")
    wav, dur = pipe(SHORT_TEXT, "en", one, 2)
    check_audio(wav[0], float(dur[0]), pipe.sample_rate, "compat ONNX pipeline")
    log(f"  compat.load_text_to_speech(<phase 9 bundle>): OnnxPipeline, one 2-step call "
        f"{float(dur[0]):.3f}s of audio in {time.perf_counter() - t0:.2f}s with the load")


def cli_module(assets, smi: str) -> None:
    """python -m supertonic_tpu_torch writes a WAV that passes check_audio."""
    out = os.path.join(OUT_DIR, "cli_out")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, TTS_RATE_CACHE_DIR=os.path.join(OUT_DIR, "rates", "cli"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "supertonic_tpu_torch", "--assets-dir", assets,
                           "--n-test", "1", "--total-step", "5", "--text", MID_TEXT,
                           "--save-dir", out], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
    if proc.returncode != 0:
        raise AssertionError(f"python -m supertonic_tpu_torch: {proc.stderr[-2000:]}")
    files = sorted(f for f in os.listdir(out) if f.endswith(".wav"))
    if not files:
        raise AssertionError("python -m supertonic_tpu_torch wrote no WAV")
    wav, sr = read_wav(os.path.join(out, files[0]))
    check_audio(wav, len(wav) / sr, sr, "python -m supertonic_tpu_torch")
    log(f"  python -m supertonic_tpu_torch: {files} ({len(wav) / sr:.3f}s at {sr} Hz) in "
        f"{time.perf_counter() - t0:.2f}s of process ({smi})")


def progress_programs(params, smi: str) -> None:
    """infer_with_progress through the text, cross, step and vocoder
    programs against an eager twin with the same seed, f32 and bf16 (bit
    for bit), its host launch calls under torch.profiler and its wall
    beside the eager twin's; infer_batch(noise=...) through the text and
    acoustic programs against the eager twin, bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    cfg, proc, texts, style, noise = whole_path_inputs(4)
    one = style.take(slice(0, 1))
    for precision in ("f32", "bf16"):
        eng = SynthesisEngine(params, cfg, proc, precision=precision, seed=3)
        twin = eager_twin(params, cfg, proc, precision=precision, seed=3)
        calls = []
        got = eng.infer_with_progress(MID_TEXT, "en", one, total_step=5,
                                      progress_callback=lambda s, n: calls.append((s, n)))
        want = twin.infer_with_progress(MID_TEXT, "en", one, total_step=5)
        if calls != [(i, 5) for i in range(1, 6)]:
            raise AssertionError(f"progress callbacks {calls}")
        hold_bit_equal(f"progress B1/5-step {precision}: programs vs eager (wav, duration)",
                       [torch.as_tensor(x) for x in got], [torch.as_tensor(x) for x in want])
        kinds = sorted({st["key"][0] for st in eng.programs.stats()})
        if kinds != ["cross", "step", "text", "vocoder"]:
            raise AssertionError(f"progress programs {kinds}")
        got = eng.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
        want = twin.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
        hold_bit_equal(f"injected noise B4/2-step {precision}: programs vs eager (wav, "
                       f"duration)", [torch.as_tensor(x) for x in got],
                       [torch.as_tensor(x) for x in want])
        if precision == "bf16":
            _shapes, per_call = recorded(eng, lambda: eng.infer_with_progress(
                MID_TEXT, "en", one, total_step=5))
            check_exact(per_call, PER_BATCH["bf16"],
                        "one replayed B1/5-step progress call (the b64 batch's counts)")
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            for what, e in (("programs", eng), ("eager", twin)):
                e.infer_with_progress(MID_TEXT, "en", one, total_step=5)  # warm
                torch.cuda.synchronize()
                with profile(activities=acts) as prof:
                    e.infer_with_progress(MID_TEXT, "en", one, total_step=5)
                    torch.cuda.synchronize()
                n_launch, n_graph, n_copy = host_launches(prof)
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    e.infer_with_progress(MID_TEXT, "en", one, total_step=5)
                    walls.append(time.perf_counter() - t0)
                log(f"  progress B1/5-step bf16, {what}: {n_launch} host launch calls "
                    f"({n_graph} graph launches, {n_launch / 5:.1f} a step), {n_copy} memcpy "
                    f"calls; wall {' / '.join(f'{w * 1e3:.2f}' for w in walls)} ms "
                    f"({smi}, a reading)")
                if what == "programs" and (n_launch > PROGRESS_MAX_HOST_LAUNCHES
                                           or n_graph != 3 + 5):
                    raise AssertionError(f"a replayed progress call: {n_launch} host launch "
                                         f"calls, {n_graph} graph launches")
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                eng.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
                torch.cuda.synchronize()
            n_launch, n_graph, n_copy = host_launches(prof)
            log(f"  injected noise B4/2-step bf16, programs: {n_launch} host launch calls "
                f"({n_graph} graph launches), {n_copy} memcpy calls")
            if n_launch > MAX_HOST_LAUNCHES or n_graph != 2:
                raise AssertionError("the injected-noise path launched more than its programs")
        log_programs(eng, f"the {precision} progress and injected-noise engine")
        del eng, twin


def trace_b64(assets) -> None:
    """Replayed b64/5-step batches under utils.timing.device_trace: the
    Chrome trace exists and names each hand-written kernel of the bf16 path
    as often as the per-batch counts say in the second of two batches
    traced back to back (the tracer lost up to ~24 of the first replayed
    kernels of its window late in this script; the first batch takes that
    loss)."""
    from torch.profiler import record_function

    from supertonic_tpu_torch.utils.timing import device_trace

    os.environ["TTS_RATE_CACHE_DIR"] = os.path.join(OUT_DIR, "rates", "main-bf16")
    tts = TTS(assets)
    style = tts.get_voice_style("M1")
    texts = [TEXTS[i % 3] for i in range(64)]
    tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=5)  # captured
    n_programs = len(tts.engine.programs.stats())
    logdir = os.path.join(OUT_DIR, "device_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    with device_trace(logdir) as prof:
        tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=5)
        torch.cuda.synchronize()
        with record_function("second batch"):
            tts.synthesize_batch(texts, ["en"] * 64, style.tile(64), total_step=5)
            torch.cuda.synchronize()
    if len(tts.engine.programs.stats()) != n_programs:
        raise AssertionError("the traced batches captured a new program")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    start = min(e["ts"] for e in events if e.get("name") == "second batch")
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    second = [e["name"] for e in events if e.get("cat") == "kernel" and e["ts"] >= start]
    found = {k: sum(any(n in name for n in TRACE_NAMES[k]) for name in second)
             for k in PER_BATCH["bf16"]}
    log(f"  device_trace of two replayed b64/5-step batches: {os.path.basename(prof.trace_path)} "
        f"({os.path.getsize(prof.trace_path) / 2**20:.1f} MiB, {len(kernels)} kernel events, "
        f"{len(second)} in the second batch); hand-written kernels named in the second: {found}")
    if found != PER_BATCH["bf16"]:
        raise AssertionError(f"the trace names {found}, expected {PER_BATCH['bf16']}")
    del tts


def native_frontend(assets) -> None:
    """The C++ frontend built from the port's sources: ids and masks equal
    to the Python frontend on the protocol texts and a seeded fuzz set,
    chunks equal on the stream text, and TTS_NATIVE_FRONTEND=1 serving
    through it."""
    from supertonic_tpu_torch.frontend import chunker, native

    t0 = time.perf_counter()
    lib = native.load_native()
    if lib is None:
        raise AssertionError("the native frontend did not build")
    log(f"  native frontend: {native._LIB_PATH} built and loaded in "
        f"{time.perf_counter() - t0:.2f}s")
    idx = build_default_indexer()
    py, cc = UnicodeProcessor(idx), native.NativeUnicodeProcessor(idx)
    rng = np.random.default_rng(0)
    pools = (list(range(0x20, 0x7F)) + list(range(0xA0, 0x100)) + list(range(0xAC00, 0xAC80))
             + list(range(0x2010, 0x2030)) + [0x1F600, 0x2764, 0x2026])
    fuzz = ["".join(chr(int(c)) for c in rng.choice(pools, int(rng.integers(1, 120))))
            for _ in range(NATIVE_FUZZ)]
    langs = [str(rng.choice(["en", "ko", "es", "pt", "fr"])) for _ in range(NATIVE_FUZZ)]
    for what, texts, lg in (("protocol texts", list(TEXTS), ["en"] * 3),
                            (f"{NATIVE_FUZZ} seeded fuzz texts", fuzz, langs)):
        (ip, mp), (ic, mc) = py(texts, lg), cc(texts, lg)
        same = np.array_equal(ip, ic) and np.array_equal(mp, mc)
        log(f"  native vs Python frontend, {what}: ids and masks equal {same}")
        if not same:
            raise AssertionError(f"native frontend differs on the {what}")
    for max_len in (120, 300):
        if native.native_chunk_text(STREAM_TEXT, max_len) != chunker._chunk_text_py(
                STREAM_TEXT, max_len):
            raise AssertionError("native chunker differs on the stream text")
    os.environ["TTS_NATIVE_FRONTEND"] = "1"
    try:
        tts = TTS(assets)
        if not isinstance(tts.engine.processor, native.NativeUnicodeProcessor):
            raise AssertionError("TTS_NATIVE_FRONTEND=1 did not select the native frontend")
        wav, dur = tts.synthesize(MID_TEXT, tts.get_voice_style("M1"), total_step=5)
        check_audio(wav[0], float(dur[0]), tts.sample_rate, "native frontend synthesis")
    finally:
        del os.environ["TTS_NATIVE_FRONTEND"]
    log(f"  TTS_NATIVE_FRONTEND=1: TTS() served {float(dur[0]):.3f}s of audio through "
        f"NativeUnicodeProcessor; the chunker equal on the stream text at 120 and 300")
    del tts


def up_matmul_vocoder(params, smi: str) -> None:
    """The vocoder's up_matmul lever against the conv path at b64 (T=448,
    the tail masked): f32 max abs diff, and both device times in f32 and
    bf16 as readings; then TTS_VOC_UP_MATMUL=1 read by an engine."""
    from supertonic_tpu_torch.models import load_params, vocoder

    cfg = TTSConfig()
    gen = torch.Generator(device=DEV).manual_seed(6)
    lat = torch.randn((64, 448, cfg.latent_channels), generator=gen, device=DEV)
    fm = (torch.arange(448, device=DEV) < 420).float()
    for dtype in (torch.float32, torch.bfloat16):
        mods = load_params({"vocoder": params["vocoder"]}, device=DEV, dtype=dtype)["vocoder"]
        with torch.inference_mode():
            run = {up: (lambda up=up: vocoder.apply(mods, cfg, lat, frame_mask=fm, dtype=dtype,
                                                   up_matmul=up)) for up in (False, True)}
            conv, mm = run[False](), run[True]()
            err = float((mm - conv).abs().max())
            ms = {up: time_ms(fn, 3) for up, fn in run.items()}
        log(f"  vocoder b64 T=448 {dtype}: up_matmul vs conv max abs diff {err:.3e}"
            + (f" (limit {UP_MATMUL_F32_ATOL:g})" if dtype == torch.float32 else " (printed)")
            + f"; device ms conv {ms[False]:.3f}, up_matmul {ms[True]:.3f} ({smi}, readings)")
        if dtype == torch.float32 and not err <= UP_MATMUL_F32_ATOL:
            raise AssertionError("up_matmul disagrees with the conv path in f32")
        del mods
    cfg, proc, texts, style, noise = whole_path_inputs(4)
    os.environ["TTS_VOC_UP_MATMUL"] = "1"
    try:
        eng = SynthesisEngine(params, cfg, proc)
    finally:
        del os.environ["TTS_VOC_UP_MATMUL"]
    if not eng.up_matmul:
        raise AssertionError("TTS_VOC_UP_MATMUL=1 was not read by the engine")
    w, d = eng.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
    w0, d0 = SynthesisEngine(params, cfg, proc).infer_batch(texts, ["en"] * 4, style,
                                                            total_step=2, noise=noise)
    if not np.array_equal(d, d0):
        raise AssertionError("up_matmul changed the durations")
    log(f"  TTS_VOC_UP_MATMUL=1 engine, B4/2-step bf16 on injected noise: acoustic program "
        f"key {[st['key'] for st in eng.programs.stats() if st['key'][0] == 'acoustic']}, wav "
        f"relative L2 {rel_l2(w, w0):.3e} against the conv path")


def smoke_tool(assets, smi: str) -> None:
    """python -m supertonic_tpu_torch.tools.smoke_test on the card: the CLI
    in its default, batch, long-form and graph-bundle modes over the smoke
    params (the bundle exported from them), each WAV checked for size."""
    env = dict(os.environ, TTS_RATE_CACHE_DIR=os.path.join(OUT_DIR, "rates", "smoke_tool"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "supertonic_tpu_torch.tools.smoke_test",
                           "--assets-dir", assets], capture_output=True, text=True,
                          timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
    if proc.returncode != 0:
        raise AssertionError(f"tools.smoke_test: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout.splitlines()[-1])
    log(f"  python -m supertonic_tpu_torch.tools.smoke_test: {summary['wavs']} WAVs over "
        f"{sorted(summary['modes'])} in {time.perf_counter() - t0:.2f}s ({smi})")


def single_card_surface(assets, params, smi: str) -> None:
    """Phase 10."""
    compat_surface(assets, smi)
    cli_module(assets, smi)
    smoke_tool(assets, smi)
    progress_programs(params, smi)
    trace_b64(assets)
    native_frontend(assets)
    up_matmul_vocoder(params, smi)


# ---------------------------------------------------------------------------
# phase 7: the serving path
# ---------------------------------------------------------------------------

# ~900 characters, four chunks of at most 300: the protocol texts run on
STREAM_TEXT = " ".join((LONG_TEXT, MID_TEXT, LONG_TEXT, MID_TEXT, SHORT_TEXT))
N_CONCURRENT = 64
WINDOW_FRAMES = 64            # the HTTP stream's vocoder window
WINDOW_F32_ATOL = 1e-5        # windowed vs whole vocoding, f32 on the card
STREAM_TURNS = 3              # timed /tts/stream against /tts turns


def fresh_rate_dir(name: str) -> None:
    """Point the engines made next at an empty learned-rate cache, so that a
    rate left by an earlier run cannot change the latent buckets."""
    d = os.path.join(OUT_DIR, "rates", name)
    shutil.rmtree(d, ignore_errors=True)
    os.environ["TTS_RATE_CACHE_DIR"] = d


def request(port: int, method: str, path: str, body=None):
    """One HTTP request to the local server: (status, headers, payload)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def expect(port, method, path, body, status, what):
    got, hdrs, payload = request(port, method, path, body)
    if got != status:
        raise AssertionError(f"{what}: HTTP {got} (want {status}): {payload[:200]!r}")
    return hdrs, payload


def check_wav_payload(payload: bytes, sr: int, what: str) -> np.ndarray:
    if payload[:4] != b"RIFF" or payload[8:12] != b"WAVE":
        raise AssertionError(f"{what}: not a RIFF/WAVE payload")
    wav, got_sr = read_wav(io.BytesIO(payload))
    if got_sr != sr:
        raise AssertionError(f"{what}: sample rate {got_sr}, want {sr}")
    check_audio(wav, len(wav) / sr, sr, what)
    return wav


class serving_server:
    """make_server(tts) on a free local port, served from a thread; shut
    down, batcher included, on exit."""

    def __init__(self, tts):
        self.server = make_server(tts, "127.0.0.1", 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.service.close()
        self.server.server_close()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise AssertionError("server thread did not stop")


def burst(port: int, sr: int, n: int, steps: int = 5):
    """n concurrent /tts requests (the protocol texts, cycled), released
    together; every answer checked. Returns (audio samples per request,
    client latency per request, wall of the burst)."""
    out = [None] * n
    gate = threading.Barrier(n)

    def hit(i):
        gate.wait()
        t0 = time.perf_counter()
        status, _h, payload = request(port, "POST", "/tts",
                                      {"text": TEXTS[i % 3], "total_step": steps})
        out[i] = (status, payload, time.perf_counter() - t0)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(o is None for o in out):
        raise AssertionError("a concurrent /tts request did not finish")
    samples, lat = [], []
    for i, (status, payload, dt) in enumerate(out):
        if status != 200:
            raise AssertionError(f"/tts request {i}: HTTP {status}: {payload[:200]!r}")
        samples.append(len(check_wav_payload(payload, sr, f"/tts request {i}")))
        lat.append(dt)
    return samples, lat, wall


def stream_first_bytes(port: int, body: dict):
    """POST /tts/stream; returns (seconds to the first audio bytes, seconds
    to the end, the body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/tts/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or resp.getheader("Transfer-Encoding") != "chunked":
            raise AssertionError(f"/tts/stream: HTTP {resp.status}")
        got, t_first = bytearray(), None
        while True:
            piece = resp.read1(1 << 16)
            if not piece:
                break
            got.extend(piece)
            if t_first is None and len(got) > 44:  # past the RIFF header
                t_first = time.perf_counter() - t0
        return t_first, time.perf_counter() - t0, bytes(got)
    finally:
        conn.close()


def stream_against_whole(port: int, sr: int) -> float:
    """/tts/stream of STREAM_TEXT against /tts of it: one turn of each to
    warm what only these requests reach (a lone chunk at B=1, the vocoder
    windows), then STREAM_TURNS timed turns, every body checked. The
    median time to the stream's first audio bytes must beat the median
    /tts. Returns that median TTFA."""
    body = {"text": STREAM_TEXT, "total_step": 5}
    firsts, ends, wholes = [], [], []
    for turn in range(1 + STREAM_TURNS):
        t_first, t_end, streamed = stream_first_bytes(port, body)
        t0 = time.perf_counter()
        _h, whole = expect(port, "POST", "/tts", body, 200, "/tts of the stream text")
        t_whole = time.perf_counter() - t0
        if t_first is None:
            raise AssertionError("/tts/stream sent no audio")
        pcm = np.frombuffer(streamed[44:], "<i2") / 32767.0
        check_audio(pcm, len(pcm) / sr, sr, "/tts/stream body")
        check_wav_payload(whole, sr, "/tts of the stream text")
        if turn:
            firsts.append(t_first)
            ends.append(t_end)
            wholes.append(t_whole)
    ttfa, t_whole = float(np.median(firsts)), float(np.median(wholes))
    log(f"  /tts/stream of {len(STREAM_TEXT)} chars, {STREAM_TURNS} turns after a warm one: "
        f"first audio bytes after {' / '.join(f'{t:.4f}' for t in firsts)}s (median "
        f"{ttfa:.4f}), end after {' / '.join(f'{t:.4f}' for t in ends)}s; /tts of the same "
        f"text {' / '.join(f'{t:.4f}' for t in wholes)}s (median {t_whole:.4f})")
    if not ttfa < t_whole:
        raise AssertionError("the stream's first audio did not arrive before /tts ended")
    return ttfa


def check_endpoints(port: int, sr: int) -> None:
    """Every other endpoint once: a batch as a zip, the OpenAI-compatible
    surface in wav and pcm, a blended voice, the GET endpoints, a 400 and a
    422."""
    hdrs, payload = expect(port, "POST", "/tts", {
        "text": [SHORT_TEXT, MID_TEXT], "lang": ["en", "en"], "voice_style": ["M1", "F1"],
        "batch": True, "total_step": 5}, 200, "/tts batch")
    zf = zipfile.ZipFile(io.BytesIO(payload))
    if hdrs["content-type"] != "application/zip" or len(zf.namelist()) != 2:
        raise AssertionError(f"/tts batch: {hdrs['content-type']}, {zf.namelist()}")
    for name in zf.namelist():
        check_wav_payload(zf.read(name), sr, f"/tts batch {name}")
    speech = {"input": MID_TEXT, "voice": "alloy", "total_step": 5}
    _h, wav = expect(port, "POST", "/v1/audio/speech", speech, 200, "/v1/audio/speech")
    check_wav_payload(wav, sr, "/v1/audio/speech wav")
    hdrs, pcm = expect(port, "POST", "/v1/audio/speech", dict(speech, response_format="pcm"),
                       200, "/v1/audio/speech pcm")
    if hdrs["content-type"] != "audio/pcm" or len(pcm) != len(wav) - 44:
        raise AssertionError(f"/v1/audio/speech pcm: {hdrs['content-type']}, {len(pcm)} "
                             f"bytes against the wav's {len(wav)}")
    check_audio(np.frombuffer(pcm, "<i2") / 32767.0, len(pcm) / 2 / sr, sr, "pcm")
    _h, blend = expect(port, "POST", "/tts", {"text": MID_TEXT, "voice_style": "M1+F1:0.3",
                                              "total_step": 5}, 200, "blended voice")
    check_wav_payload(blend, sr, "blended voice M1+F1:0.3")
    _h, voices = expect(port, "GET", "/voices", None, 200, "/voices")
    _h, health = expect(port, "GET", "/health", None, 200, "/health")
    hdrs, page = expect(port, "GET", "/", None, 200, "/")
    if ("M1" not in json.loads(voices)["voices"] or json.loads(health) != {"status": "ok"}
            or not hdrs["content-type"].startswith("text/html") or b"<audio" not in page):
        raise AssertionError("/voices, /health or / answered wrong")
    _h, err = expect(port, "POST", "/tts", {"text": "Hi.", "lang": "de"}, 400, "bad lang")
    _h, err2 = expect(port, "POST", "/tts", {"text": "Hi.", "total_step": 0}, 422,
                      "bad total_step")
    log(f"  /tts batch zip, /v1/audio/speech wav ({len(wav)} B) and pcm ({len(pcm)} B), "
        f"blend M1+F1:0.3, /voices, /health, /, 400 {json.loads(err)['detail']!r}, "
        f"422 {json.loads(err2)['detail']!r}: ok")


def check_stream_windows(tts, style) -> None:
    """stream_windows directly: the first chunk in windows (continuations,
    then its end), one end flag per text chunk, and each chunk's samples
    equal to its duration."""
    from supertonic_tpu_torch.frontend import chunk_text, max_len_for_lang

    sr = tts.sample_rate
    n_chunks = len(chunk_text(STREAM_TEXT, max_len=max_len_for_lang("en")))
    pieces = list(tts.engine.stream_windows(STREAM_TEXT, "en", style, total_step=5))
    chunks, cur = [], []
    for wav, secs, end in pieces:
        cur.append((wav, secs))
        if end:
            chunks.append(cur)
            cur = []
    if cur or len(chunks) != n_chunks or len(chunks[0]) < 2 or any(
            len(c) != 1 for c in chunks[1:]):
        raise AssertionError(f"stream_windows flags: {[len(c) for c in chunks]} pieces "
                             f"per chunk, {len(cur)} left open, {n_chunks} chunks")
    for i, c in enumerate(chunks):
        n = sum(len(w) for w, _ in c)
        # a chunk is trimmed to int(sr * duration) samples
        if not -1e-6 <= sum(secs for _, secs in c) * sr - n < 1.0:
            raise AssertionError(f"stream_windows chunk {i}: {n} samples != duration")
        check_audio(np.concatenate([w for w, _ in c]), n / sr, sr, f"stream chunk {i}")
    log(f"  stream_windows: {n_chunks} chunks, the first in {len(chunks[0])} windows "
        f"({len(chunks[0]) - 1} continuations), samples = durations")


def window_vs_whole(params, tts, style) -> None:
    """Windowed vocoding (the HTTP stream's windows: 64 frames, the halo the
    vocoder's receptive field) against whole vocoding of the same latent on
    the card, in f32 (TF32 off, the kernels' SIMT f32 branches) and bf16;
    the windows are replays of the window program (bf16: the server
    engine's programs, f32: programs of the f32 params)."""
    from supertonic_tpu_torch.models import load_params, vocoder
    from supertonic_tpu_torch.models.vocoder import receptive_field_frames

    cfg = tts.cfg
    eng = tts.engine
    halo, w, chunk = receptive_field_frames(cfg), WINDOW_FRAMES, cfg.chunk_size
    with torch.inference_mode():
        dev_args, *_ = eng._prepare_inputs([LONG_TEXT], ["en"], style)
        xt, _dur, fmask = synthesis.flow_fused(
            eng.params, cfg, *dev_args, torch.Generator(device=DEV).manual_seed(5), 1.05,
            5, 448, precision="bf16")
        xt, fmask = xt[:1].contiguous(), fmask
        f32 = load_params(params, device=DEV, dtype=torch.float32)
        for dtype, mods, progs in ((torch.float32, f32, programs.Programs(DEV)),
                                   (torch.bfloat16, eng.params, eng.programs)):
            prec = "f32" if dtype == torch.float32 else "bf16"
            full = vocoder.apply(mods["vocoder"], cfg, xt, frame_mask=fmask, dtype=dtype)
            xt_pad = torch.nn.functional.pad(xt, (0, 0, halo, halo))
            m_pad = torch.nn.functional.pad(fmask, (halo, halo))
            pieces = []
            t_len = xt.shape[1]
            for k0 in range(0, t_len, w):
                start = max(0, min(k0, t_len - w))
                wav = progs.vocode_window(mods, cfg, xt_pad, m_pad, start, w, halo,
                                          precision=prec, egress="f32")
                pieces.append(wav[:, (k0 - start) * chunk:(k0 - start + min(w, t_len - k0))
                                  * chunk])
            err = float((torch.cat(pieces, 1) - full).abs().max())
            log(f"  windowed vs whole vocoding, {t_len} frames in windows of {w} + 2 x "
                f"{halo} halo frames, {dtype}: max abs err {err:.3e}"
                + (f" (limit {WINDOW_F32_ATOL:g})" if dtype == torch.float32 else
                   " (printed, no limit: bf16 roundings of a different tiling)"))
            if dtype == torch.float32 and not err <= WINDOW_F32_ATOL:
                raise AssertionError("f32 windowed vocoding disagrees with whole vocoding")
            # int16 egress from the head's epilogue: each window's samples the
            # encoding of its f32 samples, and the whole vocoding's of its own;
            # where the f32 windows equal the whole, so do the int16 ones
            full16 = vocoder.apply(mods["vocoder"], cfg, xt, frame_mask=fmask, dtype=dtype,
                                   egress="int16")
            pieces16 = []
            for k0, piece in zip(range(0, t_len, w), pieces):
                start = max(0, min(k0, t_len - w))
                wav = progs.vocode_window(mods, cfg, xt_pad, m_pad, start, w, halo,
                                          precision=prec, egress="int16")
                pieces16.append(wav[:, (k0 - start) * chunk:(k0 - start + min(w, t_len - k0))
                                    * chunk])
                if not torch.equal(pieces16[-1], synthesis.encode_egress(piece, "int16")):
                    raise AssertionError(f"{dtype} int16 window at {k0}: not the encoding of "
                                         f"its f32 samples")
            if not torch.equal(full16, synthesis.encode_egress(full, "int16")):
                raise AssertionError(f"{dtype} int16 whole vocoding: not the encoding of its "
                                     f"f32 samples")
            steps = int((torch.cat(pieces16, 1).int() - full16.int()).abs().max())
            log(f"  windowed vs whole vocoding in int16 (the head's epilogue), {dtype}: "
                f"each the encoding of its f32 samples, bit for bit; max difference "
                f"{steps} steps{' (bit-equal required: the f32 samples are)' if err == 0 else ''}")
            if err == 0 and steps != 0:
                raise AssertionError("int16 windowed vocoding differs from whole vocoding")
    del f32


def check_progress(tts, style) -> None:
    calls = []
    wav, dur = tts.engine.infer_with_progress(
        MID_TEXT, "en", style, total_step=5, progress_callback=lambda s, n: calls.append((s, n)))
    if calls != [(i, 5) for i in range(1, 6)]:
        raise AssertionError(f"infer_with_progress callbacks {calls}")
    check_audio(wav[0], float(dur[0]), tts.sample_rate, "infer_with_progress")
    log(f"  infer_with_progress: callbacks {calls}, {float(dur[0]):.3f}s of finite audio")


def check_mulaw(assets, style, sr: int) -> None:
    """TTS(egress_format="mulaw") against TTS() on the same noise (same seed,
    same pinned rate): within the G.711 step of the int16 audio."""
    out = {}
    for fmt in ("int16", "mulaw"):
        tts = TTS(assets, egress_format=fmt)
        tts.engine._pin_rate()
        out[fmt] = tts.synthesize(MID_TEXT, style, total_step=5)
    (w16, d16), (wmu, dmu) = out["int16"], out["mulaw"]
    err = np.abs(wmu - w16) * 32767.0
    bound = (np.abs(w16) * 32767.0 + 132.0) / 32.0 + 2.0  # half a segment step
    log(f"  mu-law egress: durations equal {np.array_equal(d16, dmu)}, max |mulaw - int16| "
        f"{float(err.max()):.1f} int16 steps, max over the G.711 half-step bound "
        f"{float((err / bound).max()):.3f}")
    check_audio(wmu[0], float(dmu[0]), sr, "mu-law egress")
    if not np.array_equal(d16, dmu) or wmu.shape != w16.shape or np.any(err > bound):
        raise AssertionError("mu-law egress off the int16 audio by more than the G.711 step")


def serving(assets, params, smi: str):
    """Phase 7: the bf16 server (64 concurrent requests, coalescing, every
    endpoint, streaming against /tts), stream_windows, windowed against
    whole vocoding, the progress path and mu-law egress, then an int8
    server. Returns {kernel: {shape: launches per streamed chunk}} for every
    shape either server gave a kernel: the shapes phase 5 also checks."""
    from supertonic_tpu_torch.frontend import chunk_text, max_len_for_lang

    fresh_rate_dir("serve-bf16")
    tts = TTS(assets)
    sr = tts.sample_rate
    style = tts.get_voice_style("M1")
    ops.reset_launch_counts()
    with ops.record_launches() as shapes, serving_server(tts) as srv:
        batcher, prof = srv.server.service.batcher, tts.engine.profiler
        burst(srv.port, sr, N_CONCURRENT)  # the rate learned, the allocator warm
        b0, r0, a0 = batcher.stats["batches"], batcher.stats["batched_requests"], \
            prof.audio_seconds
        seen = {st["key"] for st in tts.engine.programs.stats()}
        samples, lat, wall = burst(srv.port, sr, N_CONCURRENT)
        new = [st for st in tts.engine.programs.stats() if st["key"] not in seen]
        log(f"  programs captured during the timed burst: {len(new)} "
            f"({sum(st['capture_s'] for st in new):.3f}s of capture: "
            f"{[st['key'] for st in new]})")
        n_batches = batcher.stats["batches"] - b0
        n_req = batcher.stats["batched_requests"] - r0
        audio = prof.audio_seconds - a0
        if abs(sum(samples) - audio * sr) > N_CONCURRENT:
            raise AssertionError(f"served samples {sum(samples)} != durations "
                                 f"{audio * sr:.1f} (one sample each at most)")
        log(f"  {N_CONCURRENT} concurrent /tts: all 200, RIFF/WAVE at {sr} Hz, RMS > 0.005, "
            f"samples = durations; batcher {n_batches} batches for {n_req} requests "
            f"({n_req / n_batches:.2f} a batch)")
        if n_req != N_CONCURRENT or not n_req / n_batches > 1.0:
            raise AssertionError("the batcher did not coalesce the concurrent requests")
        check_endpoints(srv.port, sr)
        t_first = stream_against_whole(srv.port, sr)
        _h, metrics = expect(srv.port, "GET", "/metrics", None, 200, "/metrics")
        m = json.loads(metrics)
        dev_mem = m.get("device_memory", {}).get("devices", [{}])
        if not (m["latency_p50_s"] > 0 and m["latency_p95_s"] > 0 and m["ttfa_p50_s"] > 0
                and dev_mem[0].get("bytes_in_use", 0) > 0):
            raise AssertionError(f"/metrics lacks percentiles or device memory: {m}")
        log(f"  /metrics: latency p50 {m['latency_p50_s']:.4f}s p95 "
            f"{m['latency_p95_s']:.4f}s, ttfa p50 {m['ttfa_p50_s']:.4f}s, device memory "
            f"{dev_mem[0]['bytes_in_use'] / 2**30:.2f} GiB in use "
            f"(peak {dev_mem[0]['peak_bytes_in_use'] / 2**30:.2f})")
        check_stream_windows(tts, style)
        check_progress(tts, style)
    counts = ops.launch_counts()
    log(f"  launches over the bf16 serving run: {counts}")
    for name in ("attention", "adaln_ffn", "resblock_chain", *BF16_BLOCK_KERNELS, "linear"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched while serving")
    if any(counts[name] for name in ("int8_matmul", *W8A8_KERNELS)):
        raise AssertionError("the bf16 server launched an int8 kernel")
    if any(counts[name] for name in EPILOGUE_KERNELS):
        raise AssertionError("the bf16 server launched the bias-and-rope or gated-residual "
                             "kernel (the linear kernel's epilogue takes them)")
    lat = np.asarray(lat)
    log(f"  serving times ({smi}): TTFA {t_first:.4f}s (median, {len(STREAM_TEXT)}-char "
        f"stream, 5 steps); {N_CONCURRENT} concurrent /tts at 5 steps: client latency p50 "
        f"{np.percentile(lat, 50):.4f}s p95 {np.percentile(lat, 95):.4f}s, "
        f"{sum(samples) / sr:.3f}s of audio in {wall:.4f}s = "
        f"{sum(samples) / sr / wall:.2f} served audio-sec/s")
    first = chunk_text(STREAM_TEXT, max_len=max_len_for_lang("en"))[0]
    per_chunk, chunk_counts = recorded(tts.engine, lambda: list(
        tts.engine._vocode_stream(first, "en", style, 5, 1.05, WINDOW_FRAMES)))
    log(f"  launches for one streamed chunk ({len(first)} chars, windows of "
        f"{WINDOW_FRAMES}; replays of its flow and window programs): {chunk_counts}")
    window_vs_whole(params, tts, style)
    log_programs(tts.engine, "the bf16 server's engine")
    del tts
    check_mulaw(assets, style, sr)

    fresh_rate_dir("serve-int8")
    tts8 = TTS(assets, precision="int8")
    ops.reset_launch_counts()
    with ops.record_launches() as shapes8, serving_server(tts8) as srv:
        samples8, _lat8, wall8 = burst(srv.port, sr, 16)
        t_first8, _t, body8 = stream_first_bytes(srv.port, {"text": STREAM_TEXT,
                                                            "total_step": 5})
        check_audio(np.frombuffer(body8[44:], "<i2") / 32767.0, (len(body8) - 44) / 2 / sr,
                    sr, "int8 /tts/stream body")
    counts8 = ops.launch_counts()
    log(f"  int8 server: 16 concurrent /tts ({sum(samples8) / sr:.3f}s of audio in "
        f"{wall8:.4f}s) and one stream (first audio after {t_first8:.4f}s); launches "
        f"{counts8}")
    for name in ("attention", "resblock_chain", *W8A8_KERNELS, *BF16_BLOCK_KERNELS, "linear"):
        if not counts8[name] > 0:
            raise AssertionError(f"{name} was not launched by the int8 server")
    if counts8["adaln_ffn"] or counts8["int8_matmul"]:
        raise AssertionError("the int8 server launched the fused FFN or the int32 product")
    if any(counts8[name] for name in EPILOGUE_KERNELS):
        raise AssertionError("the int8 server launched the bias-and-rope or gated-residual "
                             "kernel (the W8A8 product's epilogue takes them)")
    log_programs(tts8.engine, "the int8 server's engine")
    del tts8
    served = {kernel: {key: per_chunk[kernel].get(key, 0)
                       for key in {**shapes[kernel], **shapes8[kernel], **per_chunk[kernel]}}
              for kernel in ops.KERNELS}
    log("  shapes for phase 5 (launches per streamed chunk): " + "; ".join(
        f"{kernel} {len(seen)}: {dict(sorted(seen.items()))}" for kernel, seen in served.items()))
    return served


# ---------------------------------------------------------------------------
# phase 11: the mesh (data and tensor parallelism), multihost, the pod, the
# graph backend under a mesh and the port's tools
# ---------------------------------------------------------------------------

# a b64/5-step batch over two data shards: each shard's counts are a B=32
# batch's, which are a b64 batch's
DP_PER_BATCH = {name: 2 * n for name, n in PER_BATCH["bf16"].items()}
DP_F32_WAV_ATOL = 1e-5       # f32 wav, mesh vs single device, B=8
DP_BF16_REL_L2_MAX = 0.01    # bf16 wav, mesh vs single device, b64
TP_F32_WAV_ATOL = 5e-5       # the JAX mesh tests' TP bound
GRAPH_DP_WAV_ATOL = 3e-5     # the graph backend under a mesh, f32
MESH_SEED = 5


def programs_count(eng) -> int:
    """Programs captured so far over every shard of an engine."""
    return sum(len(s.programs.stats()) for s in eng.shards if s.programs is not None)


def mesh_engines(params, proc, precision: str, mesh, **kw):
    """(single-device engine, mesh engine) on the same params and seed,
    both at the fixed 1/11 s/char rate, so that they pick the same buckets."""
    cfg = TTSConfig()
    out = (SynthesisEngine(params, cfg, proc, precision=precision, seed=MESH_SEED,
                           device=DEV, **kw),
           SynthesisEngine(params, cfg, proc, precision=precision, seed=MESH_SEED, mesh=mesh,
                           **kw))
    for eng in out:
        eng._pin_rate(1.0 / 11.0)
        eng._rate_frozen = True
    return out


def same_seed(eng, texts, style, steps):
    """One batch from the engine's seed, as a fresh engine would draw it."""
    eng._seed_chain.manual_seed(MESH_SEED)
    return eng.infer_batch(texts, ["en"] * len(texts), style, total_step=steps)


def mesh_dp(params, smi: str) -> dict:
    """Phase 11 (a): SynthesisEngine(mesh=make_mesh(devices=[cuda:0, cuda:0]))
    at the b64/5-step bf16 cell: audio, counters exactly twice a B=32
    shard's, durations bit-equal to the single-device engine with the same
    seed in bf16 and (B=8) f32, the f32 wav within 1e-5, the bf16 wav's
    relative L2 at most 0.01, audio-sec/s beside the single-device engine;
    over distinct cards where there are several. Returns the shapes of one
    DP batch."""
    from supertonic_tpu_torch.parallel import make_mesh

    cfg, proc, _t, style, _n = whole_path_inputs(1)
    texts = [TEXTS[i % 3] for i in range(64)]
    meshes = [("[cuda:0, cuda:0]", make_mesh(devices=[DEV, DEV]))]
    if torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        meshes.append((f"{n} distinct cards", make_mesh()))
    shapes = None
    for label, mesh in meshes:
        single, dp = mesh_engines(params, proc, "bf16", mesh)
        log(f"  mesh {label}: {mesh.shape}; shards on {[str(s.device) for s in dp.shards]}, "
            f"each with its programs: {all(s.programs is not None for s in dp.shards)}")
        st = style.tile(64)
        for eng in (single, dp):  # captures: the single program, each shard's two
            eng.infer_batch(texts, ["en"] * 64, st, total_step=5)
        one = lambda: dp.infer_batch(texts, ["en"] * 64, st, total_step=5)  # noqa: E731
        if shapes is None:
            shapes, counts = recorded(dp, one)
            check_exact(counts, DP_PER_BATCH, f"one DP b64/5-step batch over {label}")
            log(f"  shapes given to each kernel in one DP batch: {shapes}")
        w1, d1 = same_seed(single, texts, st, 5)
        w2, d2 = same_seed(dp, texts, st, 5)
        for i in range(3):
            check_audio(w2[i], float(d2[i]), cfg.sample_rate, f"DP b64 row {i}")
        if not np.array_equal(d1, d2):
            raise AssertionError(f"DP durations differ from the single device's: "
                                 f"{np.abs(d1 - d2).max():.3e}")
        err = rel_l2(w2, w1)
        log(f"  (a) DP b64/5-step bf16 against the single device, same seed: durations "
            f"bit-equal, wav relative L2 {err:.6f} (<= {DP_BF16_REL_L2_MAX}), max abs "
            f"{np.abs(w2 - w1).max():.3e}")
        if not err <= DP_BF16_REL_L2_MAX:
            raise AssertionError("DP bf16 wav differs from the single device's")
        rates = {"single": [], "DP": []}
        for _rep in range(2):
            for name, eng in (("single", single), ("DP", dp)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _w, d = eng.infer_batch(texts, ["en"] * 64, st, total_step=5)
                rates[name].append(float(d.sum()) / (time.perf_counter() - t0))
        log(f"  (a) b64/5-step bf16 audio-sec/s, {label} ({smi}): DP "
            f"{' / '.join(f'{r:.2f}' for r in rates['DP'])} against the single device "
            f"{' / '.join(f'{r:.2f}' for r in rates['single'])}"
            + (" (one card: DP overhead, not scaling)" if "cuda:0, cuda:0" in label else ""))
        del single, dp
        single, dp = mesh_engines(params, proc, "f32", mesh, egress_format="f32")
        st8, t8 = style.tile(8), texts[:8]
        w1, d1 = same_seed(single, t8, st8, 5)
        w2, d2 = same_seed(dp, t8, st8, 5)
        err = float(np.abs(w2 - w1).max())
        log(f"  (a) DP B=8 f32 against the single device, same seed, {label}: durations "
            f"bit-equal {np.array_equal(d1, d2)}, wav max abs {err:.3e} (<= "
            f"{DP_F32_WAV_ATOL})")
        if not np.array_equal(d1, d2) or not err <= DP_F32_WAV_ATOL:
            raise AssertionError("DP f32 differs from the single device")
        del single, dp
    return shapes


def mesh_tp(params, devices) -> tuple[dict, int]:
    """Phase 11 (b): model=2 over ``devices`` (two), eagerly on the card: the
    f32 engine against the single device within 5e-5 on injected noise
    (B=4), attention at H/2 and no FFN-kernel launch; VE block 0's W8A8
    linears sharded bit-equal to their unsharded form in f32 and bf16 out;
    the int8 engine against the single-device int8 engine (printed).
    Returns the TP runs' shapes and the int32 product's launches."""
    from supertonic_tpu_torch.models import load_params
    from supertonic_tpu_torch.parallel import make_mesh, shard_params

    cfg, proc, texts, style, noise = whole_path_inputs(4)
    mesh = make_mesh(devices=devices, model_parallel=2)
    log(f"  (b) TP mesh {mesh}")
    single, tp = mesh_engines(params, proc, "f32", mesh, egress_format="f32")
    if any(s.programs is not None for s in tp.shards):
        raise AssertionError("a TP row captured programs")
    single.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)  # warm
    ops.reset_launch_counts()
    with ops.record_launches() as shapes:
        t0 = time.perf_counter()
        w2, d2 = tp.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    w1, d1 = single.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
    err = float(np.abs(w2 - w1).max())
    log(f"  (b) TP model=2 f32, B=4, injected noise, eager ({wall:.3f}s): launches {counts}; "
        f"against the single device: durations max abs {np.abs(d2 - d1).max():.3e}, wav max "
        f"abs {err:.3e} (<= {TP_F32_WAV_ATOL})")
    log(f"  (b) attention shapes under TP (B, H, Tq, Tk, masked): "
        f"{dict(sorted(shapes['attention'].items()))}")
    heads = {cfg.vector_estimator.n_heads // 2, cfg.text_encoder.n_heads // 2}
    if {k[1] for k in shapes["attention"]} != heads:
        raise AssertionError(f"TP attention heads {set(k[1] for k in shapes['attention'])}, "
                             f"expected {heads}")
    if counts["adaln_ffn"] or not all(counts[k] for k in ("attention", "resblock_chain",
                                                          *BLOCK_KERNELS)):
        raise AssertionError("TP: the FFN kernel ran, or attention, the chain or a block "
                             "kernel did not")
    if not err <= TP_F32_WAV_ATOL:
        raise AssertionError("TP f32 differs from the single device")
    del single, tp

    # VE block 0's W8A8 linears, sharded against unsharded, on the card
    qtree = quantize_params(params)
    sub = {"vector_estimator": {"blocks": [qtree["vector_estimator"]["blocks"][0]]}}
    m = 4 * 448
    gen = torch.Generator(device=DEV).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        (row,) = shard_params(sub, mesh, dtype=dtype)
        full = load_params(sub, device=DEV, dtype=dtype)
        sb, fb = row["vector_estimator"]["blocks"][0], full["vector_estimator"]["blocks"][0]
        names = [(s, k) for s in ("self", "cross") for k in ("q", "k", "v", "o")]
        names += [("ffn", "in"), ("ffn", "out")]
        for s, k in names:
            whole, sharded = fb[s][k], sb[s][k]
            x = torch.randn((m, whole.w_q.shape[1]), generator=gen, device=DEV).to(dtype)
            ranks = [s.w_q.device for s in sharded.shards]
            with torch.inference_mode():
                want = layers.linear(whole, x)
                got = (torch.cat([y.to(x.device) for y in layers.col_linear(sharded, x)], -1)
                       if sharded.split == "col" else layers.row_linear(
                           sharded, [c.to(d) for c, d in zip(x.chunk(2, -1), ranks)],
                           x.device))
            hold_bit_equal(f"(b) W8A8 {s}.{k} ({sharded.split}-parallel) M{m} {dtype}, "
                           f"sharded vs unsharded", (got,), (want,))

    single8, tp8 = mesh_engines(params, proc, "int8", mesh, egress_format="f32")
    w1, d1 = single8.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
    ops.reset_launch_counts()
    with ops.record_launches() as shapes8:
        w2, d2 = tp8.infer_batch(texts, ["en"] * 4, style, total_step=2, noise=noise)
    counts8 = ops.launch_counts()
    log(f"  (b) TP model=2 int8, B=4: launches {counts8}; against the single-device int8 "
        f"engine: durations max abs {np.abs(d2 - d1).max():.3e}, wav relative L2 "
        f"{rel_l2(w2, w1):.6f}, max abs {np.abs(w2 - w1).max():.3e}")
    log(f"  (b) int32 product shapes under TP int8 (M, K, N): "
        f"{dict(sorted(shapes8['int8_matmul'].items()))}")
    for name in ("attention", "resblock_chain", "int8_matmul", *W8A8_KERNELS, *BLOCK_KERNELS,
                 "linear"):
        if not counts8[name] > 0:
            raise AssertionError(f"TP int8: {name} was not launched")
    if counts8["adaln_ffn"]:
        raise AssertionError("TP int8 launched the fused FFN")
    merged = {k: {**shapes[k], **shapes8[k]} for k in ops.KERNELS}
    return merged, counts8["int8_matmul"]


def multihost_worker(pid: int, nprocs: int, port: int, assets: str) -> int:
    """One process of phase 11 (c): join the control group, build the local
    mesh, synthesize this host's shard of eight requests."""
    from supertonic_tpu_torch.assets import load_assets
    from supertonic_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=nprocs,
                         process_id=pid, initialization_timeout=120)
    counts = multihost.device_counts()
    mesh = multihost.local_mesh()
    a = load_assets(assets)
    eng = SynthesisEngine(a.params, a.cfg, a.processor, mesh=mesh)
    mine = multihost.host_shard([TEXTS[i % 3] for i in range(8)])
    style = a.get_voice_style("M1").tile(len(mine))
    wav, dur = eng.infer_batch(mine, ["en"] * len(mine), style, total_step=2)
    for w, d in zip(wav, dur):
        check_audio(w, float(d), a.cfg.sample_rate, f"process {pid}")
    print(f"MULTIPROC_OK pid={pid} nprocs={multihost.world_size()} "
          f"global_devices={sum(counts)} mesh={mesh.shape} shard={len(mine)} "
          f"egress={multihost.is_egress_host()} audio={float(dur.sum()):.3f}s", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def multihost_phase(assets) -> None:
    """Phase 11 (c): two processes on a gloo control group, each with
    local_mesh() on this machine's cards, each running its host_shard; no
    config is a no-op; a bad coordinator raises."""
    from supertonic_tpu_torch.parallel import initialize_distributed

    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, here, "--multihost-worker", str(i), "2",
                               str(port), assets], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=os.path.dirname(here))
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        stop(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        line = [x for x in out.splitlines() if x.startswith("MULTIPROC_OK")]
        if p.returncode != 0 or not line or f"pid={i} nprocs=2" not in line[0]:
            raise AssertionError(f"multihost worker {i} (rc {p.returncode}):\n{out[-3000:]}")
        log(f"  (c) {line[0]}")
    log(f"  (c) two processes in {time.perf_counter() - t0:.2f}s")
    saved = os.environ.pop("MASTER_ADDR", None)
    try:
        initialize_distributed()
    finally:
        if saved is not None:
            os.environ["MASTER_ADDR"] = saved
    if torch.distributed.is_initialized():
        raise AssertionError("initialize_distributed() without config started a group")
    code = ("from supertonic_tpu_torch.parallel import initialize_distributed\n"
            "try:\n"
            "    initialize_distributed(coordinator_address='localhost:1', num_processes=2,\n"
            "                           process_id=1, initialization_timeout=5)\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "else:\n"
            "    print('SWALLOWED')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=os.path.dirname(here), timeout=120)
    if "RAISED" not in out.stdout:
        raise AssertionError(f"a bad coordinator did not raise: {out.stdout}{out.stderr[-2000:]}")
    log(f"  (c) no config: a no-op; a bad coordinator: {out.stdout.strip()}")


def pod(assets, sr: int) -> None:
    """Phase 11 (d): two port servers (python -m
    supertonic_tpu_torch.serve.http_server) on this card behind the router:
    16 /tts requests spread over both, then one server is killed and the
    rest are served through failover."""
    from concurrent.futures import ThreadPoolExecutor

    from supertonic_tpu_torch.serve.router import Router, make_router_server

    root = os.path.dirname(os.path.abspath(__file__))
    ports = [free_port(), free_port()]
    procs, logs = [], []
    for i, port in enumerate(ports):
        env = dict(os.environ, TTS_ASSETS_DIR=assets, TTS_HOST="127.0.0.1",
                   TTS_PORT=str(port), TTS_BATCHER="1",
                   TTS_RATE_CACHE_DIR=os.path.join(OUT_DIR, "rates", f"pod-{i}"))
        env.pop("TTS_PLATFORM", None)
        f = open(os.path.join(OUT_DIR, f"pod-server-{i}.log"), "w")
        logs.append(f)
        procs.append(subprocess.Popen([sys.executable, "-m",
                                       "supertonic_tpu_torch.serve.http_server"],
                                      env=env, stdout=f, stderr=subprocess.STDOUT, cwd=root))
    router = front = None
    try:
        t0 = time.perf_counter()
        for port, p in zip(ports, procs):
            while True:
                if p.poll() is not None:
                    raise AssertionError(f"pod server on {port} exited {p.returncode}")
                try:
                    if request(port, "GET", "/health")[0] == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 240:
                    raise AssertionError(f"pod server on {port} never became healthy")
                time.sleep(0.5)
        log(f"  (d) two servers healthy after {time.perf_counter() - t0:.2f}s")
        router = Router([f"http://127.0.0.1:{p}" for p in ports], health_interval_s=0.2,
                        failure_threshold=1)
        router.check_health()
        router.start_health_loop()
        front = make_router_server(router, "127.0.0.1", 0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        fport = front.server_address[1]

        def tts_req(i):
            status, hdrs, body = request(fport, "POST", "/tts",
                                         {"text": TEXTS[i % 3], "total_step": 2})
            if status != 200:
                raise AssertionError(f"pod /tts {i}: HTTP {status} {body[:200]!r}")
            check_wav_payload(body, sr, f"pod /tts {i}")
            return len(body)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(tts_req, range(16)))
        served = [json.loads(expect(p, "GET", "/metrics", None, 200, "/metrics")[1])["requests"]
                  for p in ports]
        log(f"  (d) 16 /tts through the router in {time.perf_counter() - t0:.3f}s: "
            f"served {served} by the two servers")
        if sum(served) != 16 or min(served) == 0:
            raise AssertionError(f"the router did not spread the requests: {served}")
        procs[0].kill()
        procs[0].wait(timeout=30)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(tts_req, range(8)))
        healthy = sum(b["healthy"] for b in router.health()[1]["backends"].values())
        after = json.loads(expect(ports[1], "GET", "/metrics", None, 200, "/metrics")[1])
        log(f"  (d) server 0 killed: 8 more /tts all 200 in {time.perf_counter() - t0:.3f}s "
            f"through failover; healthy backends {healthy}; server 1 served "
            f"{after['requests'] - served[1]} of them")
        if after["requests"] - served[1] != 8:
            raise AssertionError("the surviving server did not serve the rest")
    finally:
        if front is not None:
            front.shutdown()
        if router is not None:
            router.close()
        stop(procs)
        for f in logs:
            f.close()


def graph_mesh_and_tools(params) -> None:
    """Phase 11 (e): phase 9's bundle under a DP mesh against the single
    device (f32, B=8, within 3e-5); the port's parity_check --skip-ort
    exits 0 on it; bench_onnx_backend prints both modes."""
    from supertonic_tpu_torch.assets.onnx_backend import load_onnx_backend
    from supertonic_tpu_torch.parallel import make_mesh

    from supertonic_tpu_torch.config import load_tts_json

    bundle = os.path.join(OUT_DIR, "graph_bundle")
    cfg = load_tts_json(os.path.join(bundle, "tts.json"))
    with open(os.path.join(bundle, "unicode_indexer.json")) as f:
        proc = UnicodeProcessor(np.asarray(json.load(f), np.int64))
    backend = load_onnx_backend(bundle, cfg, matmul_precision="float32", bf16_storage=False,
                                device=DEV)
    engines = [SynthesisEngine(None, cfg, proc, precision="f32",
                               seed=MESH_SEED, egress_format="f32", backend=backend,
                               mesh=mesh)
               for mesh in (None, make_mesh(devices=[DEV, DEV]))]
    for eng in engines:
        eng._pin_rate(1.0 / 11.0)
        eng._rate_frozen = True
    _cfg, _proc, texts, style, noise = whole_path_inputs(8)
    (w1, d1), (w2, d2) = (same_seed(e, texts, style, 2) for e in engines)
    err = float(np.abs(w2 - w1).max())
    log(f"  (e) graph backend under a DP mesh, f32, B=8, same seed: durations max abs "
        f"{np.abs(d2 - d1).max():.3e}, wav max abs {err:.3e} (<= {GRAPH_DP_WAV_ATOL}); "
        f"shards with programs: {sum(s.programs is not None for s in engines[1].shards)}")
    (n1, e1), (n2, e2) = (e.infer_batch(texts, ["en"] * 8, style, total_step=2, noise=noise)
                          for e in engines)
    err_n = float(np.abs(n2 - n1).max())
    log(f"  (e) the same on injected noise: wav max abs {err_n:.3e}")
    if max(err, err_n) > GRAPH_DP_WAV_ATOL or np.abs(d2 - d1).max() > 1e-6:
        raise AssertionError("the graph backend under a mesh differs from the single device")
    del engines, backend
    root = os.path.dirname(os.path.abspath(__file__))
    for tool, args in (("parity_check", ["--skip-ort", "--total-step", "2"]),
                       ("bench_onnx_backend", ["--n", "3", "--total-step", "2"])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"supertonic_tpu_torch.tools.{tool}",
                            "--assets-dir", bundle, *args], capture_output=True, text=True,
                           cwd=root, timeout=600)
        last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        log(f"  (e) python -m supertonic_tpu_torch.tools.{tool} {' '.join(args)}: rc "
            f"{r.returncode} in {time.perf_counter() - t0:.2f}s: {last}")
        if r.returncode != 0:
            raise AssertionError(f"{tool} failed:\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
        out = json.loads(last)
        if tool == "parity_check" and out["parity_ok"] is not True:
            raise AssertionError("parity_check did not pass")
        if tool == "bench_onnx_backend" and not ("adapter" in out and "fused" in out):
            raise AssertionError("bench_onnx_backend did not print both modes")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one b64/5-step batch in phases 3 and 4")
    ap.add_argument("--pin-rate", action="store_true",
                    help="phases 3 and 4 at the latent buckets of a fixed 1/11 s/char "
                         "(T=640 for the b64 cell), learning no rate")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2 and 11 (a)-(b) alone: on several cards, DP over all "
                         "of them and TP over cuda:0 and cuda:1 too")
    ap.add_argument("--multihost-worker", nargs=4, metavar=("PID", "NPROCS", "PORT", "ASSETS"),
                    help=argparse.SUPPRESS)  # one process of phase 11 (c)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.multihost_worker:
        pid, nprocs, port, assets_dir = args.multihost_worker
        return multihost_worker(int(pid), int(nprocs), int(port), assets_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 1: device (TF32 disabled for matmuls and cuDNN convs)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    smi = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
           else f"nvidia-smi unavailable: {torch.cuda.get_device_name(0)}")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    log("phase 2: build (ptxas register and spill report)")
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    log(f"  built {', '.join(libs)} in {time.perf_counter() - t0:.2f}s into "
        f"build/{next(iter(libs.values())).parent.name} (a hash of the sources)")
    check_instructions(libs)

    params = smoke_params(TTSConfig())
    if args.mesh_only:
        log("phase 11 (a): data parallelism at the b64/5-step bf16 cell")
        mesh_dp(params, smi)
        log("phase 11 (b): tensor parallelism, model=2, B=4, eager")
        mesh_tp(params, [DEV, DEV])
        if torch.cuda.device_count() > 1:
            mesh_tp(params, [torch.device("cuda", 0), torch.device("cuda", 1)])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    assets = os.path.join(OUT_DIR, "assets")
    os.makedirs(assets, exist_ok=True)
    save_params(os.path.join(assets, "params.npz"), params)
    log("phase 3: main path, TTS() bf16 at the default 66M config")
    fresh_rate_dir("main-bf16")
    cell, rates, counts = main_path(assets, "bf16", args.profile, args.pin_rate)
    launches = {name: counts[name] for name in ("attention", "adaln_ffn", "resblock_chain",
                                                *BF16_BLOCK_KERNELS, "linear")}
    log("phase 3, second engine: the b64 cell with SynthesisEngine(fused_ffn=False)")
    unfused_ffn_cell(assets, rates, smi)
    log("phase 3, third engine: the b64 cell with SynthesisEngine(fused_resblocks=False)")
    unfused_shapes = unfused_resblocks_cell(assets, rates, smi)
    log("phase 4: int8 path, TTS(precision=\"int8\") at the default 66M config")
    fresh_rate_dir("main-int8")
    cell8, _rates8, counts8 = main_path(assets, "int8", args.profile, args.pin_rate,
                                        bf16_rates=rates)
    for name in (*W8A8_KERNELS, *EPILOGUE_KERNELS):  # kernels of the int8 path alone
        launches[name] = counts8[name]
        cell[name] = cell8[name]
    # the LayerNorm kernel's quantizing form: the VE's ln1, ln2 and ln3 in the int8 batch
    cell["ln_modulate quantize form"] = {key: n for key, n in cell8["ln_modulate"].items()
                                         if len(key) == 5}
    launches["ln_modulate quantize form"] = sum(cell["ln_modulate quantize form"].values())
    log(f"  the LayerNorm's quantizing form in the b64/5-step int8 batch: "
        f"{launches['ln_modulate quantize form']} launches of its "
        f"{sum(cell8['ln_modulate'].values())} ({LN_QUANTIZE_FORM} required)")
    if launches["ln_modulate quantize form"] != LN_QUANTIZE_FORM:
        raise AssertionError("the int8 batch's LayerNorms did not take the quantizing form")
    # the W8A8 product's launches in the b64/5-step int8 batch by form
    by_form = dict.fromkeys(W8A8_FORMS, 0)
    for key, n in cell8["w8a8_matmul"].items():
        by_form[key[3] if len(key) == 5 else "bias or silu"] += n
    log(f"  W8A8 products of the b64/5-step int8 batch by form: {by_form} (exactly "
        f"{W8A8_FORMS} required)")
    if by_form != W8A8_FORMS:
        raise AssertionError("the int8 batch's W8A8 products did not take the rope, residual "
                             "and silu-quantize forms")
    for form in ("rope", "residual"):
        launches[f"w8a8_matmul {form} form"] = by_form[form]
    # the bf16 linear kernel's residual form: its launches in the bf16 batch
    cell["linear residual form"] = {key: n for key, n in cell["linear"].items()
                                    if key[3] == "residual"}
    launches["linear residual form"] = sum(cell["linear residual form"].values())
    launches["w8a8_matmul silu-quantize form"] = by_form["silu_quantize"]

    # phase 7 runs here, before phase 5, so that phase 5 also holds attention
    # and the chain against their plain versions at the shapes serving gave them
    log("phase 7: serving, make_server(TTS()) at the default 66M config")
    served = serving(assets, params, smi)

    # phase 11 (a)-(d) run here too, so that phase 5 holds each kernel at the
    # shapes the mesh gave it; (e) needs phase 9's bundle and runs last
    log("phase 11 (a): data parallelism, SynthesisEngine(mesh=make_mesh(devices=[cuda:0, "
        "cuda:0])) at the b64/5-step bf16 cell")
    dp_shapes = mesh_dp(params, smi)
    log("phase 11 (b): tensor parallelism, model=2 over [cuda:0, cuda:0], B=4, eager")
    tp_shapes, launches["int8_matmul"] = mesh_tp(params, [DEV, DEV])
    log("phase 11 (c): multihost, two processes on a gloo control group")
    multihost_phase(assets)
    log("phase 11 (d): the pod, two port servers behind the router, failover")
    pod(assets, 44100)
    for kernel in ops.KERNELS:  # checked (not timed) in phase 5
        for shape in {**dp_shapes[kernel], **tp_shapes[kernel]}:
            served[kernel].setdefault(shape, 0)
    for shape in unfused_shapes["conv1d"]:  # checked, and timed at the cell's size
        served["conv1d"].setdefault(shape, 0)

    # phase 12 runs here too, so that phase 5 holds and times each path
    # kernel at the widths it gave them
    log("phase 12: widths: the whole path at five configs off the default widths, f32 "
        "card vs CPU and bf16")
    widths = widths_phase(smi)

    log("phase 5: kernels vs plain versions")
    results = {name: [] for name in SOURCES}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    check_attention(gen, cell, results, served, widths)
    check_ffn(gen, cell, results, served, widths)
    check_chain(gen, cell, results, served, widths)
    check_int8_matmul(gen, cell, results, tp_shapes["int8_matmul"])
    check_quantize(gen, cell, results, served)
    check_w8a8(gen, cell, results, served)
    check_w8a8_forms(gen, cell, results, served, widths)
    check_ln_modulate(gen, cell, results, served, widths)
    check_quantizing_forms(gen, cell, results, served)
    check_rope(gen, cell, results, served, widths)
    check_gated_residual(gen, cell, results, served, widths)
    check_conv1d(gen, cell, results, served, widths)
    check_linear(gen, cell, results, served, widths)
    picked = cell_summary(results, launches)

    log("phase 6: whole path: f32 card vs CPU, W8A8 linears card vs CPU, int8 vs bf16 "
        "on the card, fused projections")
    whole_path_f32(params)
    w8a8_linears(params)
    whole_path_int8(params, smi)
    fused_projections_path(params)

    log("phase 8: programs: replays of the captured fused, flow and window programs "
        "against the eager functions, f32 and bf16")
    programs_check(params)

    log("phase 9: graph bundle: the smoke params as four ONNX graphs, served by "
        "TTS(<bundle>) through the ONNX executor")
    graph_bundle(params, rates)

    log("phase 10: the rest of the single-card surface: compat, python -m, progress and "
        "injected-noise programs, device_trace, the native frontend, up_matmul")
    single_card_surface(assets, params, smi)

    log("phase 11 (e): phase 9's bundle under a DP mesh, python -m "
        "supertonic_tpu_torch.tools.parity_check and bench_onnx_backend")
    graph_mesh_and_tools(params)

    line = []
    for name, (src, replaces) in SOURCES.items():
        r = picked[name]
        line.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if "pair_ms" in r:  # a form beside the replaced design and the pair it replaces
            line[-1].update(earlier_ms=r["earlier_ms"], pair_ms=r["pair_ms"])
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
