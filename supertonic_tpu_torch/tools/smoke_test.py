"""Smoke test over the port's CLI, the counterpart of the JAX package's
``tools/smoke_test.sh`` (the reference's test_all.sh modes):

    python -m supertonic_tpu_torch.tools.smoke_test [--platform cpu]
        [--assets-dir DIR] [--modes default batch longform bundle]

Each mode runs ``python -m supertonic_tpu_torch.serve.cli`` in its own
process, as a user would: one sentence (default), two sentences in two
languages with two voices (batch), a paragraph that the chunker splits
(long-form), and the graph-bundle serving path (bundle) over the four ONNX
graphs that ``assets/onnx_export.py`` writes from the same params. Success
is every exit code 0 and every WAV on disk: over 1,000 bytes for the native
modes, non-empty for the bundle (as the original exempts its bundle from
the size gate), and at least as many WAVs as the modes make. The last line
of the output is a JSON summary. The CLI runs on ``--platform`` (default the
card; it raises without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LONG = ("The morning sun rose slowly over the quiet town. Shops opened one by "
        "one, and the smell of fresh bread drifted along the street. By noon, the "
        "square was full of people. Children chased each other around the old "
        "fountain while their parents talked in the shade. A musician played a slow "
        "tune on a worn guitar, and nobody seemed in any hurry at all. When evening "
        "came, lanterns flickered to life along every doorway, and the town settled "
        "into its usual calm.")
# mode: (CLI arguments, WAVs it writes)
MODES = {
    "default": ([], 1),
    "batch": (["--batch", "--text", "First test sentence.", "Deuxième phrase de test.",
               "--lang", "en", "fr", "--voice-style", "M1", "F1"], 2),
    "longform": (["--text", LONG], 1),
    "bundle": (["--text", "Graph bundle smoke."], 1),
}
MIN_WAV_BYTES = 1000


def export_bundle_from(assets_dir: str | None, out_dir: str, seed: int = 0) -> str:
    """The four ONNX graphs (+ tts.json, model_config.json and the indexer)
    of the params in ``assets_dir`` (random-init from ``seed`` without one)."""
    from ..assets.onnx_export import export_bundle
    from ..assets.store import load_assets

    assets = load_assets(assets_dir, seed=seed)
    export_bundle(assets.params, assets.cfg, out_dir, indexer=assets.processor.indexer)
    return out_dir


def run_cli(args: list[str], env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "supertonic_tpu_torch.serve.cli", *args],
                          capture_output=True, text=True, env=env, cwd=REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--assets-dir", default=None,
                    help="native bundle (params.npz); random-init weights when absent")
    ap.add_argument("--modes", nargs="+", choices=list(MODES), default=list(MODES))
    ap.add_argument("--total-step", type=int, default=2)
    args = ap.parse_args(argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]]
                                                  if env.get("PYTHONPATH") else []))
    env.pop("TTS_ASSETS_DIR", None)
    env.pop("TTS_ONNX_DIR", None)
    common = ["--platform", args.platform, "--n-test", "1", "--total-step",
              str(args.total_step)]
    failures, wavs = [], {}
    with tempfile.TemporaryDirectory(prefix="stk_smoke_") as out:
        for mode in args.modes:
            extra, n_wavs = MODES[mode]
            save = os.path.join(out, mode)
            assets = args.assets_dir
            if mode == "bundle":
                assets = export_bundle_from(args.assets_dir, os.path.join(out, "graphs"))
            cli = common + (["--assets-dir", assets] if assets else []) + extra
            print(f"== {mode} mode", flush=True)
            r = run_cli(cli + ["--save-dir", save], env)
            if r.returncode != 0:
                failures.append(f"{mode}: exit {r.returncode}: {r.stderr[-2000:]}")
                continue
            found = sorted(f for f in os.listdir(save) if f.endswith(".wav")) \
                if os.path.isdir(save) else []
            floor = 1 if mode == "bundle" else MIN_WAV_BYTES + 1
            sizes = {f: os.path.getsize(os.path.join(save, f)) for f in found}
            for f, size in sizes.items():
                print(f"  {mode}/{f}: {size} bytes", flush=True)
                if size < floor:
                    failures.append(f"{mode}/{f}: {size} bytes < {floor}")
            if len(found) < n_wavs:
                failures.append(f"{mode}: {len(found)} WAVs, expected {n_wavs}")
            wavs[mode] = sizes
    ok = not failures
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print(json.dumps({"smoke_ok": ok, "platform": args.platform,
                      "wavs": sum(len(v) for v in wavs.values()), "modes": wavs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
