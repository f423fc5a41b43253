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
               printing ptxas's register and spill report
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
               the default's, and the bf16 wav distance between the two
  4. int8    — the same through TTS(precision="int8"), the W8A8 path: the
               VE block linears through the quantize kernel and the int8
               product with its rescale-and-bias epilogue, no fused FFN
  5. kernels — each kernel against its plain PyTorch version on the card,
               at the cell's shapes recorded in phases 3 and 4, at the
               smaller shapes of a T=256 batch and at the tile edges of
               the bf16 kernels, in f32 and bf16 (the int8 product, the
               quantize pass and the W8A8 product bit for bit), with
               kernel / plain / library times and bounds, and the earlier
               kernels' times beside this run's at the cell's shapes
               (EARLIER_MS); also at every shape that phase 7 recorded
               (the batcher's groups at B <= 32, streaming and progress at
               B=1, the chain on the vocoder windows, the int8 server's
               quantize and W8A8 shapes), timed where a streamed chunk
               launches them
  6. whole   — one batch through the whole path in f32 on the card
               (kernels) and on the CPU (plain versions); the W8A8 linears
               of one VE block, card vs CPU; int8 against bf16 on the
               card; one b64 batch with fused projections against the
               unfused one, in bf16 and int8; injected noise throughout
  7. serving — runs after phase 4, before phase 5: make_server(TTS()) on a
               local port with the batcher answers 64 concurrent /tts
               requests (checked, coalesced), every other endpoint, and a
               ~900-character /tts/stream whose first audio must arrive
               before /tts of the same text completes (medians of three
               turns after a warm one); stream_windows,
               windowed against whole vocoding (f32 held to 1e-5, bf16
               printed), infer_with_progress and mu-law egress; an int8
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
               a replayed b64 batch under utils.timing.device_trace naming
               each hand-written kernel; the native C++ frontend built from
               the port's sources, equal to the Python frontend, serving
               under TTS_NATIVE_FRONTEND=1; the vocoder's up_matmul against
               the conv path at b64 and TTS_VOC_UP_MATMUL=1 in an engine.
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
Each TTS() reads and writes its learned speaking rate under a fresh folder
of supertonic_tpu_torch/build/smoke/rates, so no earlier run steers the
latent buckets. The line before the last is a JSON object of per-kernel numbers, taken at
the cell's shape that spends the most kernel time per batch; the last line
is ``{"ok": true, "device": {...}}``.

f32 checks run with TF32 disabled for matmuls and cuDNN convs, so the plain
versions on the card are true f32 references.
"""

from __future__ import annotations

import http.client
import io
import json
import os
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
from supertonic_tpu_torch.ops import (_build, attention, ffn, int8_matmul, quantize,
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
# kernel launches per b64/5-step batch at the default config: attention 2 per
# VE block and step + 20 in TE/DP, the fused FFN 1 per VE block and step,
# W8A8 linears (a quantize pass and a W8A8 product each) 8 per VE block and
# step + 2 per block for the cross K/V; the int32 int8 product is off the path
PER_BATCH = {
    "bf16": {"attention": 80, "adaln_ffn": 30, "resblock_chain": 2, "int8_matmul": 0,
             "w8a8_matmul": 0, "quantize": 0},
    "int8": {"attention": 80, "adaln_ffn": 0, "resblock_chain": 2, "int8_matmul": 0,
             "w8a8_matmul": 252, "quantize": 252},
    # SynthesisEngine(fused_ffn=False): the AdaLN FFN as linear, silu, linear
    "bf16 unfused FFN": {"attention": 80, "adaln_ffn": 0, "resblock_chain": 2,
                         "int8_matmul": 0, "w8a8_matmul": 0, "quantize": 0},
}
W8A8_KERNELS = ("w8a8_matmul", "quantize")
# with fused projections: qkv, o, cross q, o, ffn in, out per VE block and
# step, the cross kv once per block
FUSED_W8A8_LINEARS = 6 * (6 * 5 + 1)
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
    # the W8A8 linear's quantize prologue (XLA ops in the JAX package)
    "quantize": ("supertonic_tpu_torch/csrc/quantize.cu",
                 "supertonic_tpu/models/layers.py:84"),
}
# ms per launch at the cell's shapes (bf16; int8 for the int8 product) as the
# kernels took them before the FFN's redesign and the W8A8 epilogue:
# chip_smoke.py phase 5 on an NVIDIA H100 80GB HBM3 at 700.00 W, kernel build
# hash fb4eb80f8363927d (PERF.md section 6); for w8a8_matmul, the int32
# product it replaces on the path. Printed beside this run's times; keys are
# the shapes ops.record_launches tallies.
INT32_PRODUCT_MS = {(40960, 512, 512): 0.0679, (40960, 512, 2048): 0.2119,
                    (40960, 2048, 512): 0.1699, (23680, 512, 512): 0.0414}
EARLIER_MS = {
    "attention": {(64, 8, 640, 640, True): 0.3948, (64, 8, 640, 370, True): 0.2523,
                  (64, 4, 320, 320, True): 0.0619, (64, 4, 320, 50, False): 0.0403},
    "adaln_ffn": {(64, 640, 512, 2048): 1.982},
    "resblock_chain": {(64, 40960, 128): 10.017, (64, 5120, 256): 6.072},
    "int8_matmul": INT32_PRODUCT_MS,
    "w8a8_matmul": INT32_PRODUCT_MS,
    "quantize": {},
}
DEV = torch.device("cuda")
CELL_ROWS = 64 * 640  # rows of a b64 batch at its T=640 bucket
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "supertonic_tpu_torch", "build", "smoke")


def log(msg: str) -> None:
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
            lib=None, reps=10, shape=None, ops_dtype=None):
    """Time kernel, plain version and library call; log and keep one row.
    n_cell = launches at this shape per b64/5-step batch (0: not the cell's);
    shape = the cell's shape key, under which the earlier time is looked up;
    ops_dtype = the type whose peak rate bounds the operations (dtype's)."""
    ms = time_ms(fn, reps)
    plain_ms = time_ms(plain, reps)
    lib_ms = None if lib is None else time_ms(lib, reps)
    bnd, by = bound(nbytes, nops, ops_dtype or dtype)
    lib_txt = "None" if lib_ms is None else f"{lib_ms:.4f}"
    earlier = EARLIER_MS[kernel].get(shape) if n_cell and dtype != torch.float32 else None
    earlier_txt = "" if earlier is None else f" (earlier: {earlier} ms)"
    log(f"  {kernel} {name} {dtype}: kernel_ms={ms:.4f}{earlier_txt} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_txt} bound_ms={bnd:.4f} ({by}) cell_launches={n_cell}")
    results[kernel].append(dict(name=name, dtype=dtype, n_cell=n_cell, max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bnd, bound_by=by, earlier_ms=earlier))


def check_attention(gen, cell, results, serving):
    cases = [  # name, B, H, Tq, Tk, mask kind, launches per cell batch (None:
        #        checked, not timed)
        ("ve_self T256", 64, 8, 256, 256, "tail", 0),
        ("ve_cross Tk242", 64, 8, 256, 242, "tail", 0),
        ("te_self L192", 64, 4, 192, 192, "tail", 0),
        ("te_cross_nomask", 64, 4, 192, 50, None, 0),
        ("fully_masked_row", 4, 8, 64, 96, "one_row_empty", None),
        ("long_1100", 2, 8, 1100, 1100, "tail", 0),
        # the bf16 kernel's tile edges: 64 queries a block, 64 keys a stage
        ("edge Tq65 Tk63", 3, 2, 65, 63, "tail", None),
        ("edge Tq65 Tk63 no mask", 3, 2, 65, 63, None, None),
        ("edge Tq1 Tk1", 2, 2, 1, 1, None, None),
        ("edge Tq1 Tk1 masked", 2, 2, 1, 1, "tail", None),
        ("edge B1 H1", 1, 1, 640, 640, "tail", None),
    ]
    cases += [(f"cell H{h} Tq{tq} Tk{tk}", b, h, tq, tk, "tail" if masked else None, n)
              for (b, h, tq, tk, masked), n in sorted(cell["attention"].items())]
    # the serving run's shapes, timed where a streamed chunk launches them
    cases += [(f"phase 7/11 H{h} Tq{tq} Tk{tk} ({k} per streamed chunk)", b, h, tq, tk,
               "tail" if masked else None, 0 if k else None)
              for (b, h, tq, tk, masked), k in sorted(serving["attention"].items())
              if (b, h, tq, tk, masked) not in cell["attention"]]
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, tq, tk, mk, n in cases:
            q, k, v = (torch.randn((b, t, h, 64), generator=gen, device=DEV).to(dtype)
                       for t in (tq, tk, tk))
            mask = None
            if mk is not None:
                lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen, device=DEV)
                mask = (torch.arange(tk, device=DEV)[None] < lens[:, None]).float()
                if mk == "one_row_empty":
                    mask[0] = 0.0
            got = attention.fused_attention(q, k, v, mask)
            ref = attention.attention_plain(q, k, v, mask)
            err = compare(f"attention {name} B{b} {dtype}", got, ref, dtype)
            if mk == "one_row_empty":
                mean_v = v[0].float().mean(0, keepdim=True).expand(tq, h, 64)
                if not torch.allclose(got[0].float(), mean_v, atol=TOL[dtype] * 4,
                                      rtol=TOL[dtype]):
                    raise AssertionError("fully masked row is not the mean of v")
            if n is None:
                continue
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bias = None if mask is None else (
                (1.0 - mask) * -1e9)[:, None, None, :].to(dtype)
            es = q.element_size()
            nbytes = es * b * h * 64 * (2 * tq + 2 * tk) + (0 if mask is None else 4 * b * tk)
            measure(results, "attention", name, dtype, n, err,
                    lambda: attention.fused_attention(q, k, v, mask),
                    lambda: attention.attention_plain(q, k, v, mask),
                    nbytes, 4.0 * b * h * tq * tk * 64,
                    lib=lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=bias), shape=(b, h, tq, tk, mk is not None))


def check_ffn(gen, cell, results, serving):
    """Each case: name, B, T, D, F, launches per cell batch (None: checked,
    not timed). The edges leave the bf16 GEMMs' 128-row tiles ragged (B*T
    not a multiple of 128) and the LayerNorm pass's chunks uneven across a
    warp's lanes (D 384); ragged columns are the int8 product's edges, on
    the same GEMM template."""
    cases = [("rows 64x256", 64, 256, 512, 2048, 0),
             ("edge B3 x T37", 3, 37, 512, 2048, None),
             ("edge B1 x T1", 1, 1, 512, 2048, None),
             ("edge B2 x T200, D384 F1152", 2, 200, 384, 1152, None)]
    cases += [(f"cell rows {b}x{t}", b, t, d, f, n)
              for (b, t, d, f), n in sorted(cell["adaln_ffn"].items())]
    cases += [(f"phase 7/11 rows {b}x{t} ({k} per streamed chunk)", b, t, d, f,
               0 if k else None)
              for (b, t, d, f), k in sorted(serving["adaln_ffn"].items())
              if (b, t, d, f) not in cell["adaln_ffn"]]
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


def check_chain(gen, cell, results, serving):
    """Each case: name, B, T', C, launches per cell batch (None: checked, not
    timed), frame mask ("tail": the last tenth masked, "zero": all masked)."""
    dils = (1, 3, 9)
    cases = [("T'=8x256", 64, 8 * 256, 256, 0, "tail"),
             ("T'=64x256", 64, 64 * 256, 128, 0, "tail")]
    cases += [(f"cell T'={t_len}", b, t_len, c, n, "tail")
              for (b, t_len, c), n in sorted(cell["resblock_chain"].items())]
    cases += [(f"phase 7/11 T'={t_len} ({k} per streamed chunk)", b, t_len, c,
               0 if k else None, "tail")
              for (b, t_len, c), k in sorted(serving["resblock_chain"].items())
              if (b, t_len, c) not in cell["resblock_chain"]]
    for dtype in (torch.float32, torch.bfloat16):
        edges = []  # the kernel's own tile width at each C and dtype
        for c in (128, 256):
            tile = vocoder_fused.chain_tile(c, dtype, dils)
            edges += [(f"edge T'={tile // 2 + 1} < tile {tile}", 3, tile // 2 + 1, c, None, "tail"),
                      (f"edge T'=tile+1={tile + 1}", 3, tile + 1, c, None, "tail"),
                      (f"edge T'={2 * tile + 5}, all frames masked", 2, 2 * tile + 5, c, None,
                       "zero")]
        for name, b, t_len, c, n, mk in cases + edges:
            x = torch.randn((b, t_len, c), generator=gen, device=DEV).to(dtype)
            fm = torch.zeros(t_len, device=DEV)
            if mk == "tail":
                fm[:t_len - max(1, t_len // 10)] = 1.0
            s = (3 * c) ** -0.5
            wa, wb = ((torch.rand((3, 3, c, c), generator=gen, device=DEV) * 2 - 1)
                      .mul(s).to(dtype) for _ in range(2))
            ba, bb = (0.1 * torch.randn((3, c), generator=gen, device=DEV) for _ in range(2))
            args = (x, fm, wa, ba, wb, bb, dils)
            got = vocoder_fused.resblock_chain(*args)
            ref = vocoder_fused.resblock_chain_plain(*args)
            tile = vocoder_fused.chain_tile(c, dtype, dils)
            err = compare(f"resblock_chain C={c} B{b} {name} tiles={-(-t_len // tile)} "
                          f"{dtype}", got, ref, dtype)
            if not torch.equal(got[:, -1], x[:, -1]):
                raise AssertionError("masked tail frame changed")
            if mk == "zero" and not torch.equal(got, x):
                raise AssertionError("a chain with every frame masked changed x")
            if n is None:
                continue
            es = x.element_size()
            p = len(dils)
            nbytes = es * (2 * b * t_len * c + 2 * p * 3 * c * c) + 4 * (t_len + 2 * p * c)
            measure(results, "resblock_chain", f"C={c} {name}", dtype, n, err,
                    lambda: vocoder_fused.resblock_chain(*args),
                    lambda: vocoder_fused.resblock_chain_plain(*args),
                    nbytes, 12.0 * p * c * c * b * t_len, reps=3, shape=(b, t_len, c))


def check_int8_matmul(gen, cell, results, tp):
    """Exact (max abs error 0) against the plain version, float64 sums cast
    to int32, at its path's shapes (the row-parallel W8A8 linears of phase
    11's TP int8 batch, ``tp``: (M, K, N) -> launches), at the W8A8 path's
    and at edge shapes; timed at its path's shapes (with their launches),
    at the W8A8 path's and at the edge shapes with M = 40,960."""
    cases = {(m, k, n): 0 for m in (1, 37, CELL_ROWS) for k in (32, 512, 2048)
             for n in (24, 512, 1536, 2048)}
    cases.update({shape: 0 for shape in cell["w8a8_matmul"]})
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
        if not n_cell and m < CELL_ROWS and (m, k, n) not in cell["w8a8_matmul"]:
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
    2048 (a row held in registers) and past it; timed in bf16, the path's
    type, at the cell's shapes and at the edge shapes with M = 40,960."""
    cases = {(m, k): 0 for m in (1, 37, CELL_ROWS) for k in (32, 512, 2048)}
    cases[(37, 4104)] = 0  # past 2048 the kernel reads a row twice
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
    out, at the cell's shapes, the int8 server's and edge shapes; the
    operands come from the
    quantize pass of a random x with a zero row, plus one row and one weight
    row at 127 (the largest sum, 127^2 K, rounds when made float). Timed in
    bf16, the path's type, at the cell's shapes and at the edge shapes with
    M = 40,960."""
    cases = {(m, k, n): 0 for m in (1, 37, CELL_ROWS) for k in (32, 512, 2048)
             for n in (24, 512, 2048)}
    cases.update(cell["w8a8_matmul"])  # (M, K, N): launches per cell batch
    for key in serving["w8a8_matmul"]:
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
            torch.cuda.synchronize()
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            err = float((got.float() - ref.float()).abs().max())
            ok = got.dtype == dtype and torch.equal(got.view(bits), ref.view(bits))
            log(f"  w8a8_matmul M{m} K{k} N{n} {dtype}: bit-equal {ok} (max abs err {err:g})")
            if not ok:
                raise AssertionError("w8a8_matmul disagrees with its plain version")
            if dtype == torch.float32 or n_cell is None or not n_cell and m < CELL_ROWS:
                continue
            measure(results, "w8a8_matmul", f"M{m} K{k} N{n}", dtype, n_cell, err,
                    lambda: w8a8.w8a8_matmul(*args, dtype),
                    lambda: w8a8.w8a8_matmul_plain(*args, dtype),
                    m * k + n * k + 4 * m + 8 * n + got.element_size() * m * n,
                    2.0 * m * n * k, shape=(m, k, n), ops_dtype=torch.int8)


def cell_summary(results, launches) -> dict:
    """Per kernel: the row (in the path's own dtype: bf16, or int8 for the
    int32 product) of the cell's shape that spends the most kernel time per
    batch, and the per-batch sums over the cell's shapes (for a kernel the
    path no longer launches, the sums it would take at the path's counts)."""
    line = {}
    for kernel, rows in results.items():
        cell = [r for r in rows if r["n_cell"] and r["dtype"] != torch.float32]
        if not cell:
            raise AssertionError(f"{kernel}: no shape recorded on the cell's path")
        sums = {key: (None if any(r[key] is None for r in cell)
                      else f"{sum(r['n_cell'] * r[key] for r in cell):.4f}")
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "earlier_ms")}
        where = ("per b64/5-step batch at the cell's shapes" if kernel != "int8_matmul"
                 else "per TP int8 batch of phase 11 (b), at its shapes")
        log(f"  {kernel} {where} ({cell[0]['dtype']}, "
            f"{sum(r['n_cell'] for r in cell)} launches): kernel {sums['ms']} ms "
            f"(earlier: {sums['earlier_ms']} ms), plain {sums['plain_ms']} ms, library "
            f"{sums['library_ms']} ms, bound {sums['bound_ms']} ms")
        line[kernel] = max(cell, key=lambda r: r["n_cell"] * r["ms"])
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
        if precision == "int8":
            per_batch.update(dict.fromkeys(W8A8_KERNELS, FUSED_W8A8_LINEARS))
        check_launches(counts, per_batch, 1, f"one fused b64/5-step {precision} batch")
        if precision == "int8" and any(counts[k] != FUSED_W8A8_LINEARS for k in W8A8_KERNELS):
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
TRACE_NAMES = {"attention": ("attn_mma", "attn_kernel"), "adaln_ffn": ("ln_mod", "ffn_up_f32"),
               "resblock_chain": ("chain_mma", "chain_kernel"), "int8_matmul": ("Int32Out",),
               "w8a8_matmul": ("ScaleOut",), "quantize": ("quantize_rows",)}
# host calls that launch device work: kernels and graphs
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")
MAX_HOST_LAUNCHES = 32  # per replayed b64/5-step batch
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


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
    log(f"  replayed b64/5-step batch under torch.profiler: {n_launch} host launch calls "
        f"(limit {MAX_HOST_LAUNCHES}); host calls {dict(sorted(host.items()))}")
    log(f"  hand-written kernels in its device trace: {found}; device busy {busy:.1f} ms "
        f"in {sum(e.count for e in dev)} device events; unprofiled wall {wall_s * 1e3:.1f} ms "
        f"(median of the reps), idle share {max(0.0, 1 - busy / (wall_s * 1e3)):.3f}")
    n_graphs = sum(n for k, n in host.items() if k.startswith(HOST_LAUNCH_CALLS[2:]))
    if n_launch > MAX_HOST_LAUNCHES or n_graphs < 1:
        raise AssertionError(f"one replayed batch: {n_launch} host launch calls, {n_graphs} "
                             f"of them graph launches")
    if found != per_batch:
        raise AssertionError(f"the replayed batch's trace holds {found}, expected {per_batch}")


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
    """One replayed b64/5-step batch under utils.timing.device_trace: the
    Chrome trace exists and names each hand-written kernel of the bf16 path
    as often as the per-batch counts say."""
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
    if len(tts.engine.programs.stats()) != n_programs:
        raise AssertionError("the traced batch captured a new program")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(any(n in name for n in TRACE_NAMES[k]) for name in kernels)
             for k in PER_BATCH["bf16"]}
    log(f"  device_trace of a replayed b64/5-step batch: {os.path.basename(prof.trace_path)} "
        f"({os.path.getsize(prof.trace_path) / 2**20:.1f} MiB, {len(kernels)} kernel events); "
        f"hand-written kernels named in it: {found}")
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


def single_card_surface(assets, params, smi: str) -> None:
    """Phase 10."""
    compat_surface(assets, smi)
    cli_module(assets, smi)
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
    for name in ("attention", "adaln_ffn", "resblock_chain"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched while serving")
    if any(counts[name] for name in ("int8_matmul", *W8A8_KERNELS)):
        raise AssertionError("the bf16 server launched an int8 kernel")
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
    for name in ("attention", "resblock_chain", *W8A8_KERNELS):
        if not counts8[name] > 0:
            raise AssertionError(f"{name} was not launched by the int8 server")
    if counts8["adaln_ffn"] or counts8["int8_matmul"]:
        raise AssertionError("the int8 server launched the fused FFN or the int32 product")
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
    if counts["adaln_ffn"] or not counts["attention"] or not counts["resblock_chain"]:
        raise AssertionError("TP: the FFN kernel ran, or attention or the chain did not")
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
    for name in ("attention", "resblock_chain", "int8_matmul", *W8A8_KERNELS):
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
    launches = {name: counts[name] for name in ("attention", "adaln_ffn", "resblock_chain")}
    log("phase 3, second engine: the b64 cell with SynthesisEngine(fused_ffn=False)")
    unfused_ffn_cell(assets, rates, smi)
    log("phase 4: int8 path, TTS(precision=\"int8\") at the default 66M config")
    fresh_rate_dir("main-int8")
    cell8, _rates8, counts8 = main_path(assets, "int8", args.profile, args.pin_rate,
                                        bf16_rates=rates)
    for name in W8A8_KERNELS:
        launches[name] = counts8[name]
        cell[name] = cell8[name]

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

    log("phase 5: kernels vs plain versions")
    results = {name: [] for name in SOURCES}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    check_attention(gen, cell, results, served)
    check_ffn(gen, cell, results, served)
    check_chain(gen, cell, results, served)
    check_int8_matmul(gen, cell, results, tp_shapes["int8_matmul"])
    check_quantize(gen, cell, results, served)
    check_w8a8(gen, cell, results, served)
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
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
