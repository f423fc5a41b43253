"""Export a native asset bundle to the reference's ONNX layout, the
counterpart of the JAX package's ``tools/export_onnx.py``:

    python -m supertonic_tpu_torch.tools.export_onnx --out DIR
        [--assets-dir BUNDLE] [--anonymize] [--seed 0]

writes the four graphs with tts.json, model_config.json and
unicode_indexer.json (``assets/onnx_export.py``) from the bundle's params
(random-init from ``--seed`` without one), and prints a JSON line naming
the files. Host-side serialization only: ``--platform`` is accepted for the
tools' common flags and nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--assets-dir", default=None,
                    help="native bundle (params.npz); random-init when absent")
    ap.add_argument("--anonymize", action="store_true",
                    help="opaque initializer names instead of param paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    from ..assets.onnx_export import export_bundle
    from ..assets.store import load_assets

    assets = load_assets(args.assets_dir, seed=args.seed)
    export_bundle(assets.params, assets.cfg, args.out, indexer=assets.processor.indexer,
                  anonymize=args.anonymize)
    print(json.dumps({"out": args.out, "graphs": sorted(os.listdir(args.out))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
