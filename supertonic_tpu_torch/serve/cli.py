"""CLI, the counterpart of ``supertonic_tpu.serve.cli`` with the same flags
(the reference example's --total-step --speed --n-test --voice-style --text
--lang --save-dir --batch, plus --assets-dir --precision --crossfade):

    python -m supertonic_tpu_torch.serve.cli --n-test 1 --save-dir out
    python -m supertonic_tpu_torch.serve.cli --platform cpu --batch \\
        --text "One." "Deux." --lang en fr --voice-style M1 F1 --save-dir out

It runs on the card unless ``--platform cpu`` (or ``$TTS_PLATFORM=cpu``) asks
for the CPU; without a card and without that flag it raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TTS inference on a CUDA card (PyTorch)")
    p.add_argument("--assets-dir", "--onnx-dir", dest="assets_dir",
                   type=str,
                   default=os.getenv("TTS_ASSETS_DIR")
                   or os.getenv("TTS_ONNX_DIR") or None,
                   help="Asset bundle dir (params.npz, or the four .onnx "
                        "graphs, with tts.json or model_config.json, "
                        "unicode_indexer.json, voice_styles/); --onnx-dir "
                        "is the reference's name for the same flag; "
                        "defaults to $TTS_ASSETS_DIR / $TTS_ONNX_DIR (the "
                        "reference service's env); random-init weights "
                        "when absent")
    p.add_argument("--use-gpu", action="store_true",
                   help="Accepted for reference flag parity and ignored: the "
                        "card is the default device")
    p.add_argument("--precision", type=str, default=None,
                   choices=["bf16", "f32", "int8"], help="Compute precision "
                   "(int8 = W8A8 estimator matmuls, bf16 elsewhere)")
    p.add_argument("--platform", type=str,
                   default=os.getenv("TTS_PLATFORM") or None,
                   choices=["cpu", "cuda"],
                   help="Device (default: $TTS_PLATFORM or cuda, which "
                        "raises without a card)")
    p.add_argument("--total-step", type=int, default=5,
                   help="Number of denoising steps")
    p.add_argument("--speed", type=float, default=1.05,
                   help="Speech speed (default: 1.05, higher = faster)")
    p.add_argument("--n-test", type=int, default=4,
                   help="Number of times to generate")
    p.add_argument("--batch", action="store_true", help="Batch processing")
    p.add_argument("--voice-style", type=str, nargs="+", default=["M1"],
                   help="Voice style preset name(s) or file path(s); "
                        "'A+B:t' blends two presets (t in [0,1], "
                        "default 0.5)")
    p.add_argument("--text", type=str, nargs="+", default=[
        "This morning, I took a walk in the park, and the sound of the birds "
        "and the breeze was so pleasant that I stopped for a long time just "
        "to listen."
    ])
    p.add_argument("--lang", type=str, nargs="+", default=["en"])
    p.add_argument("--save-dir", type=str, default="results")
    p.add_argument("--crossfade", type=float, default=0.0,
                   help="Crossfade seconds for long-form chunk joins "
                        "(0 = silence gaps)")
    return p.parse_args(argv)


def main(argv=None):
    from .. import TTS
    from ..engine.engine import VoiceStyle
    from ..utils import sanitize_filename, timer, write_wav

    print("=== TTS Inference (supertonic_tpu_torch) ===\n")
    args = parse_args(argv)
    if len(args.voice_style) != len(args.text):
        raise SystemExit(f"Number of voice styles ({len(args.voice_style)}) must "
                         f"match number of texts ({len(args.text)})")
    langs = args.lang
    if len(langs) == 1 and len(args.text) > 1:
        langs = langs * len(args.text)
    if len(langs) != len(args.text):
        raise SystemExit(f"Number of languages ({len(langs)}) must match number "
                         f"of texts ({len(args.text)}) (a single --lang "
                         f"broadcasts)")

    tts = TTS(args.assets_dir, precision=args.precision,
              device="cpu" if args.platform == "cpu" else None)

    def style_for(spec: str):
        # "A+B:t" blends two presets; paths (which may contain '+') keep
        # the plain lookup
        if "+" in spec and "/" not in spec and "\\" not in spec:
            from ..engine.engine import parse_blend_spec

            try:
                a, b, t = parse_blend_spec(spec)
            except ValueError as e:
                raise SystemExit(f"--voice-style: {e}")
            return tts.get_voice_style(a).blend(tts.get_voice_style(b), t)
        return tts.get_voice_style(spec)

    styles = [style_for(v) for v in args.voice_style]
    style = VoiceStyle(np.concatenate([s.ttl for s in styles]),
                       np.concatenate([s.dp for s in styles]))

    os.makedirs(args.save_dir, exist_ok=True)
    for n in range(args.n_test):
        print(f"\n[{n + 1}/{args.n_test}] Starting synthesis...")
        with timer("Generating speech from text"):
            if args.batch:
                wav, duration = tts.engine.batch(args.text, langs, style,
                                                 args.total_step, args.speed)
            else:
                wav, duration = tts.engine(
                    args.text[0], langs[0], style.take(slice(0, 1)),
                    args.total_step, args.speed,
                    crossfade_duration=args.crossfade)
        for b, w in enumerate(tts.engine.trim(wav, duration)):
            fname = f"{sanitize_filename(args.text[b], 20)}_{n + 1}.wav"
            write_wav(os.path.join(args.save_dir, fname), w, tts.sample_rate)
            print(f"Saved: {args.save_dir}/{fname}")
    print("\n=== Synthesis completed successfully! ===")


if __name__ == "__main__":
    main()
