"""Bit-faithfulness harness for the port's graph executor, the counterpart
of the JAX package's ``tools/parity_check.py``:

    python -m supertonic_tpu_torch.tools.parity_check --assets-dir DIR \\
        [--device cpu] [--total-step 5] [--skip-ort | --torch-oracle]

over a directory holding the four reference graphs. It reports, as JSON
lines:

  * the fused engine backend (``assets/onnx_backend.py``) against the
    per-call executor pipeline on identical injected noise (always
    runnable, no onnxruntime needed),
  * the vocoder bucket-padded against its exact length (bit-identical),
  * where ``onnxruntime`` imports (or with ``--torch-oracle``, the
    TorchScript twins saved beside each graph): per module and end to end
    on identical frontend inputs and noise, the executor against ORT —
    duration_predictor, text_encoder, each denoising step, the vocoder,
    the estimator chain seeded with ORT's outputs, and the executor's own
    full chain.

Exit code 0 iff every stage is within tolerance. Without onnxruntime the
ORT comparison is skipped with a clear message and the self-checks run.
The executors run on ``--device`` (default the card; it raises without
one); every comparison is in f32 with strict f32 products.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

TEXTS = [
    ("This morning, I took a walk in the park.", "en"),
    ("Une phrase pour la parité, avec des accents.", "fr"),
    ("안녕하세요, 오늘 날씨가 좋네요.", "ko"),
]


def _stats(a, b) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return {"shape_a": list(a.shape), "shape_b": list(b.shape),
                "max_abs": float("inf")}
    d = np.abs(a - b)
    denom = np.maximum(np.abs(b), 1e-6)
    return {"max_abs": float(d.max(initial=0.0)),
            "max_rel": float((d / denom).max(initial=0.0)),
            "rms": float(np.sqrt(np.mean(d * d))) if d.size else 0.0}


def _session_factory(kind: str, device=None):
    """Returns path -> session with an ORT-style .run(None, feeds)."""
    if kind == "ort":
        import onnxruntime as ort  # raises ImportError when absent

        return lambda p: ort.InferenceSession(p, providers=["CPUExecutionProvider"])
    if kind == "torch":
        return TorchOracleSession
    from ..assets.onnx_exec import OnnxSession

    return lambda p: OnnxSession(p, matmul_precision="float32", device=device)


class TorchOracleSession:
    """Torch-eager second implementation: runs the TorchScript twin saved
    next to each graph (``<name>.pt``) behind the ORT session interface, so
    the gate's full plumbing runs against an independent runtime on
    machines without onnxruntime."""

    def __init__(self, onnx_path: str):
        import torch

        from ..assets.onnx_reader import load_onnx

        pt = onnx_path[: -len(".onnx")] + ".pt"
        if not os.path.exists(pt):
            raise FileNotFoundError(f"--torch-oracle needs {pt} beside {onnx_path}")
        self._torch = torch
        self.mod = torch.jit.load(pt).eval()
        g = load_onnx(onnx_path)
        self.names = [vi.name for vi in g.inputs if vi.name not in g.initializers]

    def run(self, _outs, feeds):
        torch = self._torch
        with torch.no_grad():
            outs = self.mod(*[torch.from_numpy(np.ascontiguousarray(feeds[n]))
                              for n in self.names])
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        return [o.numpy() for o in outs]


def compare_modules(assets_dir: str, make_ref, total_step: int, tol: float,
                    device=None) -> tuple[list[dict], bool]:
    """Per-module + end-to-end diffs: executor pipeline vs reference
    sessions on identical inputs, identical injected noise."""
    from ..assets.onnx_pipeline import load_onnx_pipeline

    pipe = load_onnx_pipeline(assets_dir, matmul_precision="float32", device=device)
    refs = {name: make_ref(os.path.join(assets_dir, f"{name}.onnx"))
            for name in ("duration_predictor", "text_encoder", "vector_estimator",
                         "vocoder")}
    rng = np.random.default_rng(0)
    rows: list[dict] = []
    style = _load_any_style(assets_dir, rng)

    for text, lang in TEXTS:
        ids, mask = pipe.processor([text], [lang])
        feeds = {"text_ids": ids.astype(np.int64), "style_dp": style["dp"],
                 "text_mask": mask.astype(np.float32)}
        (dur_ref,) = refs["duration_predictor"].run(None, feeds)
        (dur_got,) = pipe.dp.run(None, feeds)
        rows.append({"stage": "duration_predictor", "text": text[:24],
                     **_stats(dur_got, dur_ref)})

        feeds_te = {"text_ids": ids.astype(np.int64), "style_ttl": style["ttl"],
                    "text_mask": mask.astype(np.float32)}
        (emb_ref,) = refs["text_encoder"].run(None, feeds_te)
        (emb_got,) = pipe.text_enc.run(None, feeds_te)
        rows.append({"stage": "text_encoder", "text": text[:24], **_stats(emb_got, emb_ref)})

        dur = np.asarray(dur_ref, np.float32) / 1.05
        chunk = pipe.base_chunk_size * pipe.chunk_compress_factor
        xt_noise = rng.standard_normal(
            (1, pipe.ldim * pipe.chunk_compress_factor,
             max(1, int(np.ceil(dur.max() * pipe.sample_rate / chunk))))).astype(np.float32)
        xt, lmask = pipe.sample_noisy_latent(dur, noise=xt_noise)
        xr = xt.copy()
        tot = np.full((1,), float(total_step), np.float32)
        for step in range(total_step):
            fe = {"text_emb": emb_ref, "style_ttl": style["ttl"],
                  "text_mask": mask.astype(np.float32), "latent_mask": lmask,
                  "current_step": np.full((1,), float(step), np.float32),
                  "total_step": tot}
            (xr,) = refs["vector_estimator"].run(None, dict(fe, noisy_latent=xr))
            (xt,) = pipe.vector_est.run(None, dict(fe, noisy_latent=xt))
            rows.append({"stage": f"vector_estimator[{step}]", "text": text[:24],
                         **_stats(xt, xr)})
        (wav_ref,) = refs["vocoder"].run(None, {"latent": xr})
        (wav_got,) = pipe.vocoder.run(None, {"latent": xr})
        rows.append({"stage": "vocoder", "text": text[:24], **_stats(wav_got, wav_ref)})
        # estimator chain end to end, seeded with ORT's dur/emb (isolates
        # estimator+vocoder accumulation from dp/encoder differences)
        rows.append({"stage": "seeded_end_to_end_wav", "text": text[:24],
                     **_stats(pipe.vocoder.run(None, {"latent": xt})[0], wav_ref)})

        # the executor's OWN chain against ORT's own chain, identical
        # injected noise; valid elementwise only when both pick the same
        # latent length, and a divergence of that geometry is a failure
        dur_e = np.asarray(dur_got, np.float32) / 1.05
        len_ref = int(np.ceil(dur.max() * pipe.sample_rate / chunk))
        len_e = int(np.ceil(dur_e.max() * pipe.sample_rate / chunk))
        if len_e != len_ref:
            rows.append({"stage": "full_own_chain_wav", "text": text[:24],
                         "max_abs": float("inf"), "max_rel": float("inf"),
                         "rms": float("inf"),
                         "note": f"latent geometry diverged ({len_e} vs {len_ref} frames)"})
        else:
            xt_e, lmask_e = pipe.sample_noisy_latent(dur_e, noise=xt_noise)
            for step in range(total_step):
                (xt_e,) = pipe.vector_est.run(None, {
                    "noisy_latent": xt_e, "text_emb": emb_got, "style_ttl": style["ttl"],
                    "text_mask": mask.astype(np.float32), "latent_mask": lmask_e,
                    "current_step": np.full((1,), float(step), np.float32),
                    "total_step": tot})
            rows.append({"stage": "full_own_chain_wav", "text": text[:24],
                         **_stats(pipe.vocoder.run(None, {"latent": xt_e})[0], wav_ref)})
    return _gate(rows, tol)


def _gate(rows: list[dict], tol: float) -> tuple[list[dict], bool]:
    for r in rows:
        r["ok"] = r["max_abs"] <= tol
    return rows, all(r["ok"] for r in rows)


def compare_fused_backend(assets_dir: str, total_step: int, tol: float,
                          device=None) -> tuple[list[dict], bool]:
    """Engine fused backend vs per-call executor pipeline — same injected
    noise (self-consistency; runs with no onnxruntime)."""
    from ..assets.onnx_backend import load_onnx_backend
    from ..assets.onnx_pipeline import load_onnx_pipeline
    from ..config import load_tts_json
    from ..engine import SynthesisEngine, VoiceStyle
    from ..frontend import UnicodeProcessor

    cfg = load_tts_json(os.path.join(assets_dir, "tts.json"))
    with open(os.path.join(assets_dir, "unicode_indexer.json")) as f:
        proc = UnicodeProcessor(np.asarray(json.load(f), np.int64))
    backend = load_onnx_backend(assets_dir, cfg, matmul_precision="float32",
                                bf16_storage=False, device=device)  # strict parity arm
    eng = SynthesisEngine(None, cfg, proc, precision="f32", backend=backend)
    pipe = load_onnx_pipeline(assets_dir, matmul_precision="float32", device=device)
    rng = np.random.default_rng(0)
    style_np = _load_any_style(assets_dir, rng)
    style = VoiceStyle(style_np["ttl"], style_np["dp"])
    rows: list[dict] = []
    for text, lang in TEXTS:
        ids, mask = pipe.processor([text], [lang])
        (d0,) = pipe.dp.run(None, {"text_ids": ids.astype(np.int64), "style_dp": style.dp,
                                   "text_mask": mask.astype(np.float32)})
        dur = np.asarray(d0, np.float32) / 1.05
        chunk = pipe.base_chunk_size * pipe.chunk_compress_factor
        t_lat = max(1, int(np.ceil(dur.max() * pipe.sample_rate / chunk)))
        c = pipe.ldim * pipe.chunk_compress_factor
        noise = rng.standard_normal((1, c, t_lat)).astype(np.float32)
        wav_pipe, dur_pipe = pipe._infer([text], [lang], style, total_step, noise=noise)
        wav_eng, dur_eng = eng.infer_batch([text], [lang], style, total_step,
                                           noise=noise.transpose(0, 2, 1))
        n = min(wav_pipe.shape[1], wav_eng.shape[1])
        rows.append({"stage": "fused_vs_pipeline_wav", "text": text[:24],
                     **_stats(wav_eng[:, :n], wav_pipe[:, :n])})
        rows.append({"stage": "fused_vs_pipeline_dur", "text": text[:24],
                     **_stats(dur_eng, dur_pipe)})
    return _gate(rows, tol)


def compare_padded_vocoder(assets_dir: str, device=None) -> tuple[list[dict], bool]:
    """Padded-vs-exact vocoder execution must be BIT-identical.

    The executor's bucket-padding guard re-zeroes padded frames after every
    conv; the guarantee also relies on every op between convs mapping 0 to
    0, which is graph-dependent, so it is checked on the bundle being
    served: the vocoder at exact length T and again padded to T + pad with
    a [T + pad] validity mask, the valid prefix equal bit for bit."""
    import torch

    from ..assets.onnx_exec import OnnxSession

    with open(os.path.join(assets_dir, "tts.json")) as f:
        cfg = json.load(f)
    ccf = int(cfg["ttl"]["chunk_compress_factor"])
    c = int(cfg["ttl"]["latent_dim"]) * ccf
    chunk = int(cfg["ae"]["base_chunk_size"]) * ccf
    exe = OnnxSession(os.path.join(assets_dir, "vocoder.onnx"),
                      matmul_precision="float32", device=device)
    dev = exe.device
    rng = np.random.default_rng(7)
    rows = []
    for t, pad in ((24, 8), (40, 24)):
        lat = rng.standard_normal((1, c, t)).astype(np.float32)
        (wav_exact,) = exe._run_traced(exe._weights, (torch.as_tensor(lat).to(dev),),
                                       torch.ones(t, device=dev))
        lat_pad = np.concatenate([lat, np.zeros((1, c, pad), np.float32)], axis=2)
        mask = np.concatenate([np.ones((t,), np.float32), np.zeros((pad,), np.float32)])
        (wav_pad,) = exe._run_traced(exe._weights, (torch.as_tensor(lat_pad).to(dev),),
                                     torch.as_tensor(mask).to(dev))
        a = wav_exact.cpu().numpy().reshape(1, -1)[:, : t * chunk]
        b = wav_pad.cpu().numpy().reshape(1, -1)[:, : t * chunk]
        row = {"stage": "padded_vs_exact_vocoder", "t": t, "pad": pad, **_stats(b, a)}
        row["ok"] = row["max_abs"] == 0.0  # bit-identical, not allclose
        rows.append(row)
    return rows, all(r["ok"] for r in rows)


def _load_any_style(assets_dir: str, rng) -> dict:
    """A real voice style when the bundle has one, else deterministic
    random with the tts.json dims (shape-compatible with the graphs only
    when those carry the real config — fine for synthetic test bundles)."""
    import glob

    for p in sorted(glob.glob(os.path.join(assets_dir, "voice_styles", "*.json"))):
        with open(p) as f:
            raw = json.load(f)
        return {"ttl": np.asarray(raw["style_ttl"]["data"], np.float32).reshape(
                    raw["style_ttl"]["dims"]),
                "dp": np.asarray(raw["style_dp"]["data"], np.float32).reshape(
                    raw["style_dp"]["dims"])}
    with open(os.path.join(assets_dir, "tts.json")) as f:
        cfgs = json.load(f)
    try:
        ttl_s = cfgs["ttl"]["style_encoder"]["style_token_layer"]
        dp_s = cfgs["dp"]["style_encoder"]["style_token_layer"]
        ttl_shape = (1, ttl_s["n_style"], ttl_s["style_value_dim"])
        dp_shape = (1, dp_s["n_style"], dp_s["style_value_dim"])
    except KeyError:
        ttl_shape = dp_shape = (1, 2, 4)  # synthetic-bundle fallback
    return {"ttl": rng.standard_normal(ttl_shape).astype(np.float32),
            "dp": rng.standard_normal(dp_shape).astype(np.float32)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assets-dir", required=True)
    ap.add_argument("--total-step", type=int, default=5)
    ap.add_argument("--tol", type=float, default=2e-4,
                    help="max |diff| gate (f32 product reassociation slack)")
    ap.add_argument("--skip-ort", action="store_true",
                    help="only run the self-checks")
    ap.add_argument("--torch-oracle", action="store_true",
                    help="compare against the TorchScript twins saved next to each "
                         "graph (<name>.pt) instead of onnxruntime")
    ap.add_argument("--device", default=None,
                    help="where the executors run (default: the card)")
    args = ap.parse_args(argv)

    all_ok = True
    rows: list[dict] = []
    if not args.skip_ort:
        if args.torch_oracle:
            make_ref = _session_factory("torch")
        else:
            try:
                make_ref = _session_factory("ort")
            except ImportError:
                print("onnxruntime not installed — skipping the ORT oracle comparison "
                      "(run on a machine with onnxruntime for the full parity gate, or "
                      "use --torch-oracle on a bundle with TorchScript twins). "
                      "Self-checks continue.", file=sys.stderr)
                make_ref = None
        if make_ref is not None:
            r, ok = compare_modules(args.assets_dir, make_ref, args.total_step, args.tol,
                                    device=args.device)
            rows += r
            all_ok &= ok
    r, ok = compare_fused_backend(args.assets_dir, args.total_step, args.tol,
                                  device=args.device)
    rows += r
    all_ok &= ok
    r, ok = compare_padded_vocoder(args.assets_dir, device=args.device)
    rows += r
    all_ok &= ok
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"parity_ok": bool(all_ok), "stages": len(rows), "tol": args.tol}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
