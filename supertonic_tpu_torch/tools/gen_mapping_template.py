"""A mapping-table template for converting a reference ONNX bundle's
weights into the port's param tree, the counterpart of the JAX package's
``tools/gen_mapping_template.py``:

    python -m supertonic_tpu_torch.tools.gen_mapping_template [--assets-dir DIR] > mapping.py

prints every param path of the config's tree (``models.init_all``, flattened
by ``assets.store.flatten_tree``) with its shape, as commented
``MappingRule`` stubs of the port's ``assets.convert``: fill each pattern
with the ONNX initializer's regex (``python -m
supertonic_tpu_torch.assets.convert_onnx --onnx-dir DIR --list-only``
lists them), then convert with ``--mapping mapping.py``. The config is
``--assets-dir``'s (model_config.json or tts.json), else the default.
Nothing runs on a device (``--platform`` is accepted for the tools' common
flags).
"""

from __future__ import annotations

import argparse
import sys


def template(cfg) -> str:
    from ..assets.store import flatten_tree
    from ..models import init_all

    flat = flatten_tree(init_all(0, cfg))
    lines = ["# Auto-generated mapping template "
             "(python -m supertonic_tpu_torch.tools.gen_mapping_template).",
             "# Fill each rule's pattern with the real ONNX initializer regex.",
             "from supertonic_tpu_torch.assets.convert import MappingRule, t_conv, t_linear",
             "", "RULES = {"]
    by_model: dict[str, list[str]] = {}
    for path, arr in sorted(flat.items()):
        model, rest = path.split("/", 1)
        kind = ""
        if rest.endswith("/w"):
            kind = ", t_conv" if arr.ndim == 3 else ", t_linear"
        by_model.setdefault(model, []).append(
            f"    # {rest:55s} {str(tuple(arr.shape)):20s}\n"
            f"    # MappingRule(r'<onnx-name-regex>', r'{rest}'{kind}),")
    for model, rules in by_model.items():
        lines += [f'  "{model}": [', *rules, "  ],"]
    lines.append("}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assets-dir", default=None,
                    help="a bundle whose config to use (default: TTSConfig())")
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    from ..assets.store import load_assets

    print(template(load_assets(args.assets_dir, init_params=False).cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
