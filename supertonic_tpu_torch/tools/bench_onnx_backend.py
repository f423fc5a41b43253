"""A/B of the port's two ONNX-graph serving modes, the counterpart of the
JAX package's ``tools/bench_onnx_backend.py``. It measures host-fetched
single-utterance latency over the SAME graph bundle:

  * adapter  (TTS_ONNX_FUSED=0): one executor call per graph call, the
    reference's 3 + total_step ORT-call cost shape;
  * fused    (default): the four graphs composed into the engine's stages
    (``assets/onnx_backend.py``), one CUDA graph per static shape on the
    card;
  * with ``--bf16`` a fused arm with bf16 activation storage
    (TTS_ONNX_BF16=1), with ``--native`` the bundle auto-mapped onto the
    native engine (``assets/automap.py``; only for graphs of the native
    architecture).

    python -m supertonic_tpu_torch.tools.bench_onnx_backend --assets-dir DIR \\
        [--device cpu] [--n 10] [--total-step 5]

Prints one JSON line: p50/p90/min milliseconds per arm and the adapter's
p50 over the fused one. Runs on the card unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

TEXT = ("The quick brown fox jumps over the lazy dog while the curious cat "
        "watches from a sunny windowsill nearby, purring.")


def _style_for(tts):
    try:
        return tts.get_voice_style("M1")
    except (FileNotFoundError, ValueError, KeyError):
        from ..engine import VoiceStyle

        rng = np.random.default_rng(4)
        s_ttl, s_dp = tts.cfg.ttl.style, tts.cfg.dp.style
        return VoiceStyle(
            rng.standard_normal((1, s_ttl.n_style, s_ttl.style_value_dim)).astype(np.float32),
            rng.standard_normal((1, s_dp.n_style, s_dp.style_value_dim)).astype(np.float32))


def measure(tts, *, n: int, steps: int, text: str) -> dict:
    style = _style_for(tts)
    for _ in range(2):  # first calls: kernel builds and graph captures
        tts.synthesize(text, style, total_step=steps)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        wav, _dur = tts.synthesize(text, style, total_step=steps)
        if not np.isfinite(np.asarray(wav)).all():
            raise RuntimeError("non-finite audio")
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {"p50_ms": float(np.median(ts) * 1e3),
            "p90_ms": float(np.percentile(ts, 90) * 1e3),
            "min_ms": float(ts.min() * 1e3)}


def native_tts(assets_dir: str, device=None):
    """The bundle's graphs auto-mapped onto the native architecture, served
    by the native engine behind the same TTS API (assets/automap.py raises
    for graphs that do not match it structurally)."""
    from .. import TTS
    from ..assets.automap import automap_bundle
    from ..config import TTSConfig, _dataclass_from_dict, load_tts_json
    from ..engine import SynthesisEngine

    full_cfg = os.path.join(assets_dir, "model_config.json")
    if os.path.exists(full_cfg):
        with open(full_cfg) as f:
            cfg = _dataclass_from_dict(TTSConfig, json.load(f))
    else:
        cfg = load_tts_json(os.path.join(assets_dir, "tts.json"))
    params, _ = automap_bundle(assets_dir, cfg)
    tts = TTS(assets_dir, device=device)  # styles and processor; engine replaced
    tts.engine = SynthesisEngine(params, cfg, tts.assets.processor, device=device)
    tts.cfg = cfg
    return tts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assets-dir", required=True,
                    help="bundle holding the four .onnx graphs + tts.json")
    ap.add_argument("--total-step", type=int, default=5)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--text", default=TEXT)
    ap.add_argument("--native", action="store_true",
                    help="add the arm of the bundle auto-mapped onto the native engine")
    ap.add_argument("--bf16", action="store_true",
                    help="add a fused arm with bf16 activation storage (TTS_ONNX_BF16)")
    ap.add_argument("--skip-adapter", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from .. import TTS

    saved = {k: os.environ.get(k) for k in ("TTS_ONNX_FUSED", "TTS_ONNX_BF16")}
    # arm isolation: a pre-exported TTS_ONNX_BF16=1 would make the fused
    # arm bf16 too
    os.environ.pop("TTS_ONNX_BF16", None)
    out: dict = {"total_step": args.total_step, "n": args.n,
                 "note": "singles latency includes waveform egress"}
    try:
        arms = [] if args.skip_adapter else [("adapter", {"TTS_ONNX_FUSED": "0"})]
        arms.append(("fused", {"TTS_ONNX_FUSED": "1"}))
        if args.bf16:
            arms.append(("fused_bf16", {"TTS_ONNX_FUSED": "1", "TTS_ONNX_BF16": "1"}))
        for name, env in arms:
            os.environ.update(env)
            tts = TTS(args.assets_dir, device=args.device)
            out[name] = measure(tts, n=args.n, steps=args.total_step, text=args.text)
            out[name]["engine"] = type(tts.engine).__name__
            del tts
            os.environ.pop("TTS_ONNX_BF16", None)
        if args.native:
            out["native"] = measure(native_tts(args.assets_dir, args.device), n=args.n,
                                    steps=args.total_step, text=args.text)
            out["fused_vs_native_p50"] = round(
                out["fused"]["p50_ms"] / out["native"]["p50_ms"], 2)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if "adapter" in out:
        out["speedup_p50"] = round(out["adapter"]["p50_ms"] / out["fused"]["p50_ms"], 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
