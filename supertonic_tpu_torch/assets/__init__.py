from .store import (
    Assets,
    flatten_tree,
    load_assets,
    load_params,
    save_params,
    synthesize_default_styles,
    unflatten_tree,
)

__all__ = [
    "Assets",
    "flatten_tree",
    "load_assets",
    "load_params",
    "save_params",
    "synthesize_default_styles",
    "unflatten_tree",
]
