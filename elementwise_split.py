#!/usr/bin/env python3
"""Where one b64/5-step batch of the port spends its device time, by kind
of kernel, by network and by the function of the layers that launched it.

    python3 elementwise_split.py                 # this checkout's package
    python3 elementwise_split.py --root DIR      # another checkout's package
                                                 # (e.g. a parent commit
                                                 # unpacked by git archive)
    python3 elementwise_split.py --precision int8

The batch is the fused program at the bucket the engine's learned rate
settles on (T=448 at the default config, as the b64 cell runs): one
``SynthesisEngine.infer_batch_begin`` of 64 protocol texts gives its
inputs. It runs twice under ``torch.profiler``: replayed from its CUDA
graph, which gives each kernel's device time, and eagerly
(``engine.synthesis.synthesize_fused``, the function the graph captured),
with the networks (``text_encoder.apply``, ``duration_predictor.apply``,
``vector_estimator.precompute_cross`` and ``step``, ``vocoder.apply``) and
the layers' functions (``models.layers``: ``linear``, ``layer_norm``,
``apply_rope``, ``mha``, ``block``, ...; those a checkout has) wrapped in
``record_function`` ranges, which names each kernel's innermost function
and outermost network around the host call that launched it (the runtime
call of the kernel's correlation id). The two runs' kernel sequences are
aligned by name, and each replayed kernel's time is credited to the eager
twin's labels (eager kernel times are not used: a card starved between
launches runs them at other clocks). Kinds: the hand-written kernels
(``csrc/``), the library's products and convolutions (cuBLAS, cuDNN) and
the rest (PyTorch's elementwise, reduction and copy kernels). The default
config with random weights made from a seed (the zero-init heads of the
vector estimator perturbed, as chip_smoke.py's ``smoke_params``). Needs a
CUDA card. Prints the card's name and power limit, the replayed batch's
largest kernels by name (template arguments included, so each instance of
a kernel on its own line), a table, and as its last line one JSON object
{kind: {network: {function: [ms, launches]}}}.
"""

from __future__ import annotations

import argparse
import difflib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter, defaultdict

HAND_WRITTEN = ("attn_rows", "attn_wgmma", "attn_wide", "chain_kernel", "chain_wgmma",
                "conv_pass", "conv_simt", "conv_wgmma", "ffn_down_f32", "ffn_up_f32",
                "gated_residual_pass",
                "layer_norm_rows", "linear_simt", "linear_wgmma", "ln_mod",
                "quantize_long_rows", "quantize_rows", "rope_pairs", "w8a8_simt", "w8a8_wgmma")
# the port's GEMM kernels, as whole template names (stk::wgmma_gemm<...>,
# mma_gemm<...>, or mangled 10wgmma_gemmI...): cuBLAS's xmma_gemm_ is not one
OWN_GEMMS = re.compile(r"(?<![A-Za-z_])(?:wgmma_gemm|mma_gemm)[<I]")
LIBRARY = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cudnn", "conv", "fprop", "Kernel2")
KERNEL_LINES = 16  # the replayed batch's largest kernels printed by name
NETWORKS = {"text_encoder": ("apply",), "duration_predictor": ("apply",),
            "vector_estimator": ("precompute_cross", "step"), "vocoder": ("apply",)}
FUNCTIONS = {"layers": ("linear", "layer_norm", "apply_rope", "_modulate", "mha", "_mha_tp",
                        "kv_project", "ffn", "block", "attention_core", "conv1d", "embedding",
                        "_split_fused", "_heads", "_close", "rope_angles", "larope_positions",
                        "sinusoidal_embedding"),
             "vector_estimator": ("velocity",), "vocoder": ("_resblock", "_up_matmul")}


def kind(name: str) -> str:
    if any(n in name for n in HAND_WRITTEN) or OWN_GEMMS.search(name):
        return "hand-written"
    if any(n in name for n in LIBRARY):
        return "library products"
    return "elementwise, reduction, copy"


def labelled(fn, label: str):
    import torch

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose supertonic_tpu_torch runs")
    ap.add_argument("--precision", default="bf16", choices=("bf16", "int8"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("elementwise_split: no CUDA device", file=sys.stderr)
        return 2
    import supertonic_tpu_torch
    from supertonic_tpu_torch import models
    from supertonic_tpu_torch.assets import synthesize_default_styles
    from supertonic_tpu_torch.config import TTSConfig
    from supertonic_tpu_torch.engine import SynthesisEngine, synthesis
    from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0))
    print(f"package: {os.path.dirname(supertonic_tpu_torch.__file__)}, {args.precision}")
    os.environ["TTS_RATE_CACHE_DIR"] = tempfile.mkdtemp()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = TTSConfig()
    params = models.init_all(0, cfg)
    rng = np.random.default_rng(42)
    ve = params["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          precision=args.precision)
    texts = [("The quick brown fox jumps over the lazy dog near the creek.",
              "This morning, I took a walk in the park, and the sound of the birds and the "
              "breeze felt so pleasant that I stopped to listen a while longer there today.",
              "This morning, I took a walk in the park, and the sound of the birds and the "
              "breeze was so pleasant that I stopped for a long time just to listen. Later, as "
              "the sun rose higher over the trees, the path slowly filled with joggers, bikers, "
              "and children going to school.")[i % 3] for i in range(64)]
    style = synthesize_default_styles(cfg)["M1"].tile(64)
    for _ in range(18):  # the learned rate writes its prior down after 16 observations
        pend = eng.infer_batch_begin(texts, ["en"] * 64, style, 5, device_output=True)
        eng.infer_batch_end(pend)
    call = dict(precision=eng.precision, egress=eng.egress_format)

    def run(fns):
        with torch.inference_mode():
            fns.synthesize_fused(eng.params, eng.cfg, *pend.dev_args,
                                 torch.Generator(device="cuda").manual_seed(7), eng._speed(1.05), 5,
                                 pend.t_bucket, **call)
        torch.cuda.synchronize()

    def device_events(prof):
        return sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                      key=lambda e: e.time_range.start)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    run(eng.programs)  # captured, or replayed
    with profile(activities=acts) as prof:
        run(eng.programs)
    replayed = device_events(prof)
    # the replayed batch's largest kernels by name, each instance of a
    # template kernel on its own line
    by_name: Counter = Counter()
    count: Counter = Counter()
    for e in replayed:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        count[e.name] += 1
    for name, ms in by_name.most_common(KERNEL_LINES):
        print(f"  kernel {ms:9.3f} ms x{count[name]:<4d} {name[:150]}")

    for mod_name, names in NETWORKS.items():
        mod = getattr(models, mod_name)
        for n in names:
            setattr(mod, n, labelled(getattr(mod, n), f"net:{mod_name}.{n}"))
    for mod_name, names in FUNCTIONS.items():
        mod = getattr(models, mod_name)
        for n in names:
            if hasattr(mod, n):
                setattr(mod, n, labelled(getattr(mod, n), f"fn:{n}"))
    run(synthesis)  # warm
    with profile(activities=acts) as prof:
        run(synthesis)
    events = prof.events()
    # host calls that launch device work, by correlation id (a kernel's id)
    launches = {e.id: e for e in events if e.device_type.name == "CPU"
                and e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset"))}
    eager = device_events(prof)

    def labels_of(ev):
        labels, e = [], launches.get(ev.id)
        if e is None:
            return "(no launch found)", "(no launch found)"
        while e is not None:
            if e.name.startswith(("net:", "fn:")):
                labels.append(e.name)
            e = e.cpu_parent
        fns = [x[3:] for x in labels if x.startswith("fn:")]
        nets = [x[4:] for x in labels if x.startswith("net:")]
        return (nets[-1] if nets else "outside the networks",
                fns[0] if fns else "(network body)")

    split = defaultdict(lambda: [0.0, 0])
    matcher = difflib.SequenceMatcher(None, [e.name for e in eager],
                                      [e.name for e in replayed], autojunk=False)
    matched = set()
    for i, j, n in matcher.get_matching_blocks():
        for k in range(n):
            ev = replayed[j + k]
            matched.add(j + k)
            cell = split[(kind(ev.name), *labels_of(eager[i + k]))]
            cell[0] += ev.time_range.elapsed_us() / 1e3
            cell[1] += 1
    for j, ev in enumerate(replayed):
        if j not in matched:  # the program's copies in and out, its noise draw
            cell = split[(kind(ev.name), "(replay only)", ev.name[:22])]
            cell[0] += ev.time_range.elapsed_us() / 1e3
            cell[1] += 1
    busy = sum(e.time_range.elapsed_us() for e in replayed) / 1e3
    unlinked = Counter(e.name[:60] for e in eager if e.id not in launches)
    print(f"{len(eager)} eager device events, {len(replayed)} replayed, {len(matched)} aligned; "
          f"eager events with no launch found: {sum(unlinked.values())} "
          f"{unlinked.most_common(4)}")
    print(f"b64/5-step {args.precision} at T={pend.t_bucket}, replayed under torch.profiler: "
          f"{len(replayed)} device events, {busy:.3f} ms")
    out: dict = {}
    for (k, net, fn), (ms, n) in sorted(split.items(), key=lambda kv: (kv[0][0], -kv[1][0])):
        print(f"  {k:30s} {net:36s} {fn:22s} {ms:9.3f} ms x{n}")
        out.setdefault(k, {}).setdefault(net, {})[fn] = [round(ms, 4), n]
    for k in sorted(out):
        print(f"  {k}: {sum(v[0] for d in out[k].values() for v in d.values()):.3f} ms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
