"""The serving precision ladder measured perceptually, the counterpart of the
JAX package's ``tools/precision_ladder.py``:

    python -m supertonic_tpu_torch.tools.precision_ladder [--platform cpu]
        [--total-step 5] [--assets-dir DIR]

Synthesizes the same utterances with the same injected noise at f32 (the
reference), bf16 (the serving default), int8 (the W8A8 estimator products)
and bf16 with mu-law egress (companded and expanded as the device egress
and the host decode do), and reports MCD, log-mel SNR and waveform SNR
against f32 (``utils.audio_metrics``): one JSON line per text and tier on
stdout, a markdown table on stderr. Runs on ``--platform`` (default the
card; it raises without one).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# two of the JAX package's protocol texts (its bench harness, which the port
# does not carry)
SHORT_TEXT = "The quick brown fox jumps over the lazy dog near the creek."
MID_TEXT = (
    "This morning, I took a walk in the park, and the sound of the birds "
    "and the breeze felt so pleasant that I stopped to listen a while "
    "longer there today.")
TIERS = {
    "f32": "f32",
    "bf16": "bf16",
    "int8": "int8",
    "bf16_mulaw8": "bf16",
}


def ungate(params: dict, cfg) -> dict:
    """Random-init weights leave every estimator block an identity (AdaLN
    zero gates), so the quantized products would never reach the output:
    the gates and the output projection from fixed generators, the same
    for every tier (as the JAX tool does)."""
    from ..models import layers as L

    hp = cfg.vector_estimator
    ve = dict(params["vector_estimator"])
    ve["adaln_out"] = L.linear_init(np.random.default_rng(7), hp.dim, 2 * hp.dim)
    ve["out_proj"] = L.linear_init(np.random.default_rng(8), hp.dim, cfg.latent_channels)
    ve["blocks"] = [dict(bp) for bp in ve["blocks"]]
    for i, bp in enumerate(ve["blocks"]):
        din, dout = bp["adaln"]["w"].shape
        bp["adaln"] = L.linear_init(np.random.default_rng(10 + i), din, dout)
    return dict(params, vector_estimator=ve)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--total-step", type=int, default=5)
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--assets-dir", default=None)
    args = ap.parse_args(argv)

    from ..assets.store import load_assets
    from ..engine import SynthesisEngine
    from ..utils import mulaw
    from ..utils.audio_metrics import precision_ladder_report

    assets = load_assets(args.assets_dir)
    cfg = assets.cfg
    params = assets.params if args.assets_dir else ungate(assets.params, cfg)
    style = assets.get_voice_style("M1")
    engines = {name: SynthesisEngine(params, cfg, assets.processor, seed=0, precision=prec,
                                     egress_format="f32", device=args.platform)
               for name, prec in TIERS.items()}
    rows = []
    for label, text in (("short", SHORT_TEXT), ("mid", MID_TEXT)):
        # one noise tensor for every tier, at the latent length f32 picks
        w0, _ = engines["f32"].batch([text], ["en"], style, args.total_step)
        noise = np.random.default_rng(11).standard_normal(
            (1, w0.shape[1] // cfg.chunk_size, cfg.latent_channels)).astype(np.float32)
        wavs = {name: eng.infer_batch([text], ["en"], style, args.total_step, 1.05,
                                      noise=noise)[0][0]
                for name, eng in engines.items()}
        wavs["bf16_mulaw8"] = mulaw.decode(mulaw.encode(wavs["bf16_mulaw8"]))
        ref = wavs.pop("f32")
        report = precision_ladder_report(ref, wavs, cfg.sample_rate, spec=cfg.ae.spec_processor)
        for tier, m in report.items():
            row = {"text": label, "tier": tier, "reference": "f32",
                   "total_step": args.total_step, "platform": args.platform,
                   **{k: round(v, 3) for k, v in m.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print("\n| text | tier | MCD (dB) | log-mel SNR (dB) | wav SNR (dB) |", file=sys.stderr)
    print("|---|---|---|---|---|", file=sys.stderr)
    for r in rows:
        print(f"| {r['text']} | {r['tier']} | {r['mcd_db']} | {r['log_mel_snr_db']} | "
              f"{r['wav_snr_db']} |", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
