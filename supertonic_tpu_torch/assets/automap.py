"""Structural ONNX -> native auto-mapper (VERDICT r2 item 3).

Maps a graph's initializers onto the native param pytree using NO name
information — only topology and shape:

1. A *skeleton* graph is exported from randomly-initialized native params
   (assets/onnx_export.py) with path-based initializer names.
2. Both graphs' initializers are listed in CONSUMPTION order (first use in
   the topologically-ordered node list) and tagged with a *role* — the
   (op_type, argument position) of their first consumer: a MatMul weight,
   an Add bias, a LayerNormalization scale, a Conv kernel, a Gather table...
3. Foreign and skeleton initializers are matched within (shape, role)
   groups by consumption order — group sizes must agree exactly, or the
   graphs are not structurally equivalent and the mapper fails loudly.
4. Matched pairs whose skeleton name is a param path land in the pytree
   (with the exporter's layout transform inverted — e.g. ONNX Conv
   [out,in,k] -> native [k,in,out]); pairs that are structural constants
   (RoPE frequency tables, reshape shapes, epsilons) are instead VALUE-
   checked — a mismatch there means the alignment is wrong, so it raises.

This replaces the hand-written MappingRule table (assets/convert.py) for
any bundle whose graphs are structurally equivalent to the native
architecture; the table remains the fallback for architecturally-foreign
graphs. Reference anchor: loading real weights is a one-liner in the
reference because ORT executes the graphs directly (py/helper.py:289-306);
here the graphs must be re-rooted into the tuned native modules.
"""

from __future__ import annotations

import numpy as np

from ..config import TTSConfig
from .onnx_reader import OnnxGraph, load_onnx, parse_model
from .store import flatten_tree, unflatten_tree

MODEL_FILES = ("duration_predictor", "text_encoder",
               "vector_estimator", "vocoder")


class AutomapError(ValueError):
    """The graph is not structurally equivalent to the native skeleton."""


def _consumption_order(graph: OnnxGraph) -> list[tuple[str, tuple, tuple]]:
    """[(init_name, role, shape)] ordered by first use; role identifies the
    consumer slot: (op_type, argument_index)."""
    inits = graph.initializers
    seen: set[str] = set()
    out = []
    for node in graph.nodes:
        for pos, inp in enumerate(node.inputs):
            if inp in inits and inp not in seen:
                seen.add(inp)
                out.append((inp, (node.op_type, pos),
                            tuple(inits[inp].dims)))
    for name, t in inits.items():  # unconsumed (shouldn't happen)
        if name not in seen:
            out.append((name, ("<unused>", 0), tuple(t.dims)))
    return out


# exporter layout transforms to invert, by consumer role
def _to_native(role: tuple, arr: np.ndarray) -> np.ndarray:
    if role[0] == "Conv" and role[1] == 1:
        # ONNX Conv weight [out, in, k] -> layers.conv1d [k, in, out]
        return np.ascontiguousarray(np.transpose(arr, (2, 1, 0)))
    if role[0] == "Gemm" and role[1] == 1:
        # torch-style Gemm(transB=1) weight [out, in] -> [in, out]
        return np.ascontiguousarray(arr.T)
    return np.asarray(arr)


def automap_graph(foreign: OnnxGraph, skeleton: OnnxGraph,
                  *, model: str = "?") -> tuple[dict[str, np.ndarray], dict]:
    """Match by (shape, role, order); returns (flat {path: array}, report)."""
    f_list = _consumption_order(foreign)
    s_list = _consumption_order(skeleton)
    if len(f_list) != len(s_list):
        raise AutomapError(
            f"{model}: initializer counts differ "
            f"({len(f_list)} foreign vs {len(s_list)} skeleton)")

    def grouped(lst):
        groups: dict[tuple, list[str]] = {}
        for name, role, shape in lst:
            groups.setdefault((shape, role), []).append(name)
        return groups

    fg, sg = grouped(f_list), grouped(s_list)
    if set(fg) != set(sg):
        only_f = sorted(set(fg) - set(sg))[:5]
        only_s = sorted(set(sg) - set(fg))[:5]
        raise AutomapError(
            f"{model}: (shape, role) groups differ; foreign-only "
            f"{only_f}, skeleton-only {only_s}")

    flat: dict[str, np.ndarray] = {}
    consts_checked = 0
    for key, f_names in fg.items():
        s_names = sg[key]
        if len(f_names) != len(s_names):
            raise AutomapError(
                f"{model}: group {key} size mismatch "
                f"({len(f_names)} vs {len(s_names)})")
        for f_name, s_name in zip(f_names, s_names):
            arr = np.asarray(foreign.initializers[f_name].data)
            if "/" in s_name:  # param path
                flat[s_name] = _to_native(key[1], arr)
            else:
                # structural constant: values must agree, or the alignment
                # is wrong (RoPE tables, shapes, eps — derived from the
                # same config on both sides)
                want = np.asarray(skeleton.initializers[s_name].data)
                if arr.shape != want.shape or not np.allclose(
                        arr.astype(np.float64), want.astype(np.float64),
                        rtol=1e-5, atol=1e-6):
                    raise AutomapError(
                        f"{model}: structural constant mismatch at group "
                        f"{key} ({f_name} vs {s_name}) — the graphs are "
                        f"not the same architecture/config")
                consts_checked += 1
    report = {"matched_params": len(flat), "consts_checked": consts_checked,
              "initializers": len(f_list)}
    return flat, report


def automap_bundle(onnx_dir: str, cfg: TTSConfig,
                   *, seed: int = 0) -> tuple[dict, dict]:
    """Auto-map all four graphs of a bundle onto a native param tree.
    Returns (params pytree, {model: report})."""
    import os

    from ..models import init_all
    from . import onnx_export as E

    skel_params = init_all(seed, cfg)
    exporters = {
        "duration_predictor": E.export_duration_predictor,
        "text_encoder": E.export_text_encoder,
        "vector_estimator": E.export_vector_estimator,
        "vocoder": E.export_vocoder,
    }
    params: dict = {}
    reports: dict = {}
    for model in MODEL_FILES:
        path = os.path.join(onnx_dir, f"{model}.onnx")
        foreign = load_onnx(path)
        skeleton = parse_model(exporters[model](skel_params[model], cfg))
        flat, rep = automap_graph(foreign, skeleton, model=model)
        # every native param slot must be filled
        want = set(flatten_tree(skel_params[model]))
        got = set(flat)
        if got != want:
            missing = sorted(want - got)[:5]
            extra = sorted(got - want)[:5]
            raise AutomapError(
                f"{model}: mapped params differ from the skeleton tree "
                f"(missing {missing}, extra {extra})")
        params[model] = unflatten_tree(flat)
        reports[model] = rep
    return params, reports
