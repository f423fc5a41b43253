from .store import (
    Assets,
    flatten_tree,
    load_assets,
    load_params,
    refuse_onnx_dir,
    save_params,
    synthesize_default_styles,
    unflatten_tree,
)

__all__ = [
    "Assets",
    "flatten_tree",
    "load_assets",
    "load_params",
    "refuse_onnx_dir",
    "save_params",
    "synthesize_default_styles",
    "unflatten_tree",
]
