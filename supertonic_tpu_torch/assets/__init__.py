from .onnx_backend import OnnxStageBackend, load_onnx_backend
from .onnx_exec import OnnxExecutor, OnnxSession, load_session
from .onnx_pipeline import OnnxPipeline, load_onnx_pipeline
from .store import (
    Assets,
    flatten_tree,
    load_assets,
    load_params,
    load_voice_style,
    save_assets,
    save_params,
    save_voice_style,
    synthesize_default_styles,
    unflatten_tree,
)

__all__ = [
    "Assets",
    "OnnxExecutor",
    "OnnxPipeline",
    "OnnxSession",
    "OnnxStageBackend",
    "flatten_tree",
    "load_assets",
    "load_onnx_backend",
    "load_onnx_pipeline",
    "load_params",
    "load_session",
    "load_voice_style",
    "save_assets",
    "save_params",
    "save_voice_style",
    "synthesize_default_styles",
    "unflatten_tree",
]
