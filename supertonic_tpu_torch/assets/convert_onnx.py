"""Convert a directory of the four reference ONNX graphs into a params.npz
bundle that ``TTS`` serves with the native engine and its kernels.

    python -m supertonic_tpu_torch.assets.convert_onnx --onnx-dir <graphs> \
        --out <bundle> [--mapping mapping.py] [--list-only] [--lenient]

The structural auto-mapper (``assets/automap.py``) comes first; the
``MappingRule`` table of ``--mapping`` (a Python file defining ``RULES =
{model: [MappingRule, ...]}``, see ``assets/convert.py``) is the fallback.
``--list-only`` prints every initializer's name, dtype and shape per graph,
the starting point of such a table. The counterpart of the JAX package's
``tools/convert_onnx.py``; numpy only, no card needed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--onnx-dir", required=True)
    ap.add_argument("--out", default="assets")
    ap.add_argument("--mapping",
                    help="python file defining RULES = {model: [MappingRule...]}")
    ap.add_argument("--list-only", action="store_true")
    ap.add_argument("--lenient", action="store_true",
                    help="fill unmapped params from the random-init skeleton")
    return ap.parse_args(argv)


def _config(onnx_dir: str):
    from ..config import TTSConfig, _dataclass_from_dict, load_tts_json

    full_cfg = os.path.join(onnx_dir, "model_config.json")
    cfg_path = os.path.join(onnx_dir, "tts.json")
    if os.path.exists(full_cfg):
        # an exported bundle carries the full hparams (tts.json alone cannot
        # rebuild layer counts and widths)
        with open(full_cfg) as f:
            return _dataclass_from_dict(TTSConfig, json.load(f))
    if os.path.exists(cfg_path):
        return load_tts_json(cfg_path)
    return TTSConfig()


def main(argv=None) -> int:
    args = parse_args(argv)
    from .convert import convert, extract_onnx_dir
    from .store import load_voice_style, save_assets

    cfg = _config(args.onnx_dir)
    if args.list_only:
        for model, inits in extract_onnx_dir(args.onnx_dir).items():
            print(f"== {model} ({len(inits)} initializers)")
            for name, arr in sorted(inits.items()):
                print(f"  {name:60s} {arr.dtype} {tuple(arr.shape)}")
        return 0

    params = None
    if args.mapping:
        spec = importlib.util.spec_from_file_location("mapping", args.mapping)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rules = mod.RULES
    else:
        # no table: the structural auto-mapper fills the whole tree or raises
        from .automap import AutomapError, automap_bundle

        try:
            params, reports = automap_bundle(args.onnx_dir, cfg)
            for model, rep in reports.items():
                print(f"automapped {model}: {rep['matched_params']} params, "
                      f"{rep['consts_checked']} structural consts verified")
        except AutomapError as e:
            print(f"[warn] structural automap failed ({e}); falling back to "
                  f"the MappingRule table (none given: everything will be "
                  f"unmapped; pass --mapping)")
        rules = {}

    if params is None:
        params, report = convert(args.onnx_dir, cfg, rules, strict=not args.lenient)
        for model, unmapped in report.items():
            if unmapped:
                print(f"[warn] {model}: {len(unmapped)} unmapped initializers")

    indexer = None
    idx_path = os.path.join(args.onnx_dir, "unicode_indexer.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            indexer = np.asarray(json.load(f), np.int64)

    # carry the bundle's voice styles: without them save_assets writes
    # synthetic presets, and real weights would speak with random speakers
    styles = None
    style_dir = os.path.join(args.onnx_dir, "voice_styles")
    if os.path.isdir(style_dir):
        styles = {os.path.splitext(f)[0]: load_voice_style([os.path.join(style_dir, f)])
                  for f in sorted(os.listdir(style_dir)) if f.endswith(".json")}
        print(f"carrying {len(styles)} voice styles")
    else:
        print("[warn] no voice_styles/ next to the graphs: writing synthetic presets")

    save_assets(args.out, cfg, params, indexer=indexer, styles=styles)
    print(f"asset bundle written to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
