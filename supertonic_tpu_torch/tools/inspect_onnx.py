"""A readable architecture report of an ONNX graph bundle, the counterpart
of the JAX package's ``tools/inspect_onnx.py``:

    python -m supertonic_tpu_torch.tools.inspect_onnx --assets-dir DIR
        [--graph vocoder] [--json]

Per graph: the op histogram (subgraph bodies included), float parameter
count, the largest initializers, the I/O contract, pattern hints, and the
preflight: the ops the port's executor (``assets/onnx_exec.py``) does not
run. Reads the graphs with ``assets/onnx_reader.py``; nothing runs on a
device (``--platform`` is accepted for the tools' common flags). Exits 1
when no graph was found.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np

GRAPHS = ("duration_predictor", "text_encoder", "vector_estimator", "vocoder")


def _all_op_types(g) -> collections.Counter:
    """Op histogram including If/Loop/Scan subgraph bodies."""
    from ..assets.onnx_reader import OnnxGraph

    ops: collections.Counter = collections.Counter()
    stack = [g]
    while stack:
        cur = stack.pop()
        for n in cur.nodes:
            ops[n.op_type] += 1
            stack.extend(v for v in n.attrs.values() if isinstance(v, OnnxGraph))
    return ops


def report(path: str) -> dict:
    from ..assets.onnx_exec import _REGISTRY
    from ..assets.onnx_reader import load_onnx

    g = load_onnx(path)
    ops = _all_op_types(g)
    unsupported = sorted(o for o in ops if o not in _REGISTRY)
    n_params = 0
    shapes = []
    for name, t in g.initializers.items():
        arr = np.asarray(t.data)
        if np.issubdtype(arr.dtype, np.floating):
            n_params += arr.size
        shapes.append((name, tuple(arr.shape), str(arr.dtype)))
    hints = []
    if ops.get("Softmax") or ops.get("Einsum"):
        att = max(ops.get("Softmax", 0), ops.get("Einsum", 0) // 2)
        hints.append(f"~{att} attention blocks (Softmax/Einsum count)")
    if ops.get("ConvTranspose"):
        hints.append(f"{ops['ConvTranspose']} transposed convs (upsampling)")
    if ops.get("Conv"):
        hints.append(f"{ops['Conv']} convs")
    for norm in ("LayerNormalization", "InstanceNormalization", "GroupNormalization"):
        if ops.get(norm):
            hints.append(f"{ops[norm]} {norm}")
    if ops.get("Sin") and ops.get("Cos"):
        hints.append("Sin+Cos present (rotary/sinusoidal position math)")
    io = {"inputs": [(vi.name, list(vi.shape or ())) for vi in g.inputs
                     if vi.name not in g.initializers],
          "outputs": [(vi.name, list(vi.shape or ())) for vi in g.outputs]}
    big = sorted(shapes, key=lambda s: -int(np.prod(s[1]) if s[1] else 1))
    return {
        "nodes": len(g.nodes),
        "ops": dict(ops.most_common()),
        "float_params": n_params,
        "initializers": len(shapes),
        "largest_tensors": [{"name": n, "shape": list(sh), "dtype": dt}
                            for n, sh, dt in big[:12]],
        "io": io,
        "hints": hints,
        "unsupported_ops": unsupported,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assets-dir", required=True)
    ap.add_argument("--graph", choices=GRAPHS, default=None,
                    help="one graph (default: all four)")
    ap.add_argument("--json", action="store_true", help="one JSON object")
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    out = {}
    for name in ([args.graph] if args.graph else GRAPHS):
        path = os.path.join(args.assets_dir, f"{name}.onnx")
        if not os.path.exists(path):
            print(f"{name}: MISSING ({path})", file=sys.stderr)
            continue
        out[name] = report(path)
    if args.json:
        print(json.dumps(out))
        return 0 if out else 1
    if not out:
        return 1  # a wrong --assets-dir must not look like success
    for name, r in out.items():
        print(f"\n== {name} ==")
        print(f"  nodes: {r['nodes']}   float params: {r['float_params'] / 1e6:.2f} M   "
              f"initializers: {r['initializers']}")
        print(f"  inputs:  {r['io']['inputs']}")
        print(f"  outputs: {r['io']['outputs']}")
        top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:14]
        print("  ops: " + ", ".join(f"{k}x{v}" for k, v in top))
        for h in r["hints"]:
            print(f"  hint: {h}")
        if r["unsupported_ops"]:
            print("  EXECUTOR PREFLIGHT: unsupported ops -> " + ", ".join(r["unsupported_ops"]))
        else:
            print("  executor preflight: all ops supported")
        print("  largest tensors:")
        for t in r["largest_tensors"][:6]:
            print(f"    {t['shape']} {t['dtype']:>8}  {t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
