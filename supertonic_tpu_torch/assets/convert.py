"""ONNX -> native param-tree weight conversion framework (a copy of
``supertonic_tpu.assets.convert`` on the port's ``store``).

One-time extraction of the four reference graphs
(duration_predictor/text_encoder/vector_estimator/vocoder.onnx, reference
py/helper.py:297-300) into our param pytree + asset bundle.

The exact initializer names inside the reference graphs are unknowable until
the Hugging Face assets are present (SURVEY.md §0: not mounted here, no
egress), so the mapping is a pluggable table: each entry matches initializer
names by regex and routes the array (with optional transpose/reshape) into a
path of our pytree. ``extract_onnx_dir`` already works end-to-end today: it
parses real graphs with the dependency-free reader, dumps every initializer,
and reports unmapped names so the table can be completed against the real
checkpoints; ``validate_against_skeleton`` then shape-checks the result
against ``models.init_all``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable

import numpy as np

from ..config import TTSConfig
from .onnx_reader import load_onnx
from .store import flatten_tree, unflatten_tree

MODEL_FILES = (
    "duration_predictor",
    "text_encoder",
    "vector_estimator",
    "vocoder",
)


@dataclasses.dataclass
class MappingRule:
    """Route ONNX initializers matching ``pattern`` to pytree path
    ``target`` (str with regex group refs, '/'-joined keys)."""

    pattern: str
    target: str
    transform: Callable[[np.ndarray], np.ndarray] | None = None


# Common ONNX-export layouts -> ours:
#   torch Linear exports weight [out, in]  -> ours [in, out]  (transpose)
#   torch Conv1d exports weight [out, in, k] -> ours [k, in, out]
def t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def extract_initializers(onnx_path: str) -> dict[str, np.ndarray]:
    graph = load_onnx(onnx_path)
    return {k: v.data for k, v in graph.initializers.items()}


def extract_onnx_dir(onnx_dir: str) -> dict[str, dict[str, np.ndarray]]:
    """Parse all four graphs; returns {model_name: {init_name: array}}."""
    out = {}
    for name in MODEL_FILES:
        path = os.path.join(onnx_dir, f"{name}.onnx")
        if os.path.exists(path):
            out[name] = extract_initializers(path)
    return out


def apply_mapping(
    inits: dict[str, np.ndarray], rules: list[MappingRule]
) -> tuple[dict[str, np.ndarray], list[str]]:
    """Returns (flat params {path: array}, unmapped initializer names)."""
    flat: dict[str, np.ndarray] = {}
    unmapped: list[str] = []
    for name, arr in inits.items():
        for rule in rules:
            m = re.fullmatch(rule.pattern, name)
            if m:
                target = m.expand(rule.target)
                flat[target] = rule.transform(arr) if rule.transform else arr
                break
        else:
            unmapped.append(name)
    return flat, unmapped


def validate_against_skeleton(
    flat: dict[str, np.ndarray], cfg: TTSConfig
) -> dict[str, tuple]:
    """Shape-check mapped params against the init_all skeleton; returns
    {path: (expected_shape, got_shape)} mismatches (empty = all good)."""
    from ..models import init_all

    skeleton = flatten_tree(init_all(0, cfg))
    problems: dict[str, tuple] = {}
    for path, arr in flat.items():
        if path not in skeleton:
            problems[path] = ("<no such param>", arr.shape)
        elif tuple(skeleton[path].shape) != tuple(arr.shape):
            problems[path] = (tuple(skeleton[path].shape), tuple(arr.shape))
    return problems


def convert(
    onnx_dir: str,
    cfg: TTSConfig,
    rules: dict[str, list[MappingRule]],
    *,
    strict: bool = True,
):
    """Full conversion: parse graphs, map initializers, validate, return the
    params pytree (missing paths fall back to skeleton values when
    strict=False)."""
    from ..models import init_all

    skeleton = flatten_tree(init_all(0, cfg))
    flat_all: dict[str, np.ndarray] = {}
    report: dict[str, list[str]] = {}
    for model, inits in extract_onnx_dir(onnx_dir).items():
        flat, unmapped = apply_mapping(inits, rules.get(model, []))
        flat_all.update({f"{model}/{k}": v for k, v in flat.items()})
        report[model] = unmapped
    problems = validate_against_skeleton(flat_all, cfg)
    if problems and strict:
        raise ValueError(f"shape mismatches: {problems}")
    merged = dict(skeleton)
    merged.update({k: v for k, v in flat_all.items() if k in skeleton})
    missing = [k for k in skeleton if k not in flat_all]
    if missing and strict:
        raise ValueError(f"{len(missing)} params not covered by mapping, "
                         f"e.g. {missing[:5]}")
    return unflatten_tree(merged), report
