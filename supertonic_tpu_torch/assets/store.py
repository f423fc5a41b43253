"""Asset bundle: param checkpoint, config, unicode indexer, voice styles —
the counterpart of ``supertonic_tpu.assets.store``.

Layout of an assets directory (``<dir>/``):
    params.npz            flattened JAX-layout param tree ('/'-joined keys)
    tts.json              reference-format config
    model_config.json     full config (written by the JAX package's save_assets)
    unicode_indexer.json  dense codepoint -> id table
    voice_styles/XX.json  reference-format style files

With no directory, ``load_assets`` makes deterministic random-init params
(the JAX package's ``init_all``, bit for bit); a directory must hold
``params.npz`` (the port loads no ONNX graphs). The built-in indexer and
synthetic styles stand in for the other missing pieces.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..config import (TTSConfig, VOICE_PRESETS, _dataclass_from_dict,
                      load_tts_json)
from ..engine.engine import VoiceStyle
from ..frontend import UnicodeProcessor, build_default_indexer
from ..models import init_all


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str, params: Any) -> None:
    np.savez(path, **flatten_tree(params))


def load_params(path: str) -> Any:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def load_voice_style(paths: list[str], verbose: bool = False) -> VoiceStyle:
    """Stack reference-format style files into a batch; ``verbose`` prints
    how many were loaded, as the reference helper does."""
    ttls, dps = [], []
    for p in paths:
        with open(p) as f:
            raw = json.load(f)
        ttls.append(np.array(raw["style_ttl"]["data"], np.float32).reshape(
            raw["style_ttl"]["dims"][1:]))
        dps.append(np.array(raw["style_dp"]["data"], np.float32).reshape(
            raw["style_dp"]["dims"][1:]))
    if verbose:
        print(f"Loaded {len(paths)} voice styles")
    return VoiceStyle(np.stack(ttls), np.stack(dps))


def synthesize_default_styles(cfg: TTSConfig, seed: int = 1234) -> dict[str, VoiceStyle]:
    """Deterministic stand-in styles for the 10 presets."""
    rng = np.random.default_rng(seed)
    styles = {}
    for name in VOICE_PRESETS:
        ttl = rng.standard_normal(
            (1, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim)
        ).astype(np.float32)
        dp = rng.standard_normal(
            (1, cfg.dp.style.n_style, cfg.dp.style.style_value_dim)
        ).astype(np.float32)
        styles[name] = VoiceStyle(ttl, dp)
    return styles


@dataclass
class Assets:
    cfg: TTSConfig
    params: Any
    processor: UnicodeProcessor
    style_dir: str | None

    def get_voice_style(self, name_or_path: str) -> VoiceStyle:
        """A preset name ("M1") or a style-file path."""
        if os.path.exists(name_or_path):
            return load_voice_style([name_or_path])
        if self.style_dir:
            p = os.path.join(self.style_dir, f"{name_or_path}.json")
            if os.path.exists(p):
                return load_voice_style([p])
        if name_or_path in VOICE_PRESETS:
            return synthesize_default_styles(self.cfg)[name_or_path]
        raise FileNotFoundError(f"voice style {name_or_path!r} not found")


def refuse_onnx_dir() -> None:
    """The entry points' guard for the reference service's variable: an ONNX
    bundle given there would otherwise be served as random weights."""
    if os.getenv("TTS_ONNX_DIR"):
        raise RuntimeError("TTS_ONNX_DIR is set, but the port loads no ONNX "
                           "bundles: give a params.npz bundle as TTS_ASSETS_DIR")


def load_assets(dirpath: str | None = None, *, seed: int = 0,
                cfg: TTSConfig | None = None) -> Assets:
    """Load the asset bundle at ``dirpath``, which must hold ``params.npz``;
    with no ``dirpath``, random-init params from ``seed``. ``cfg`` is used
    when there is no directory or it holds no config."""
    cfg = cfg or TTSConfig()
    params = indexer = style_dir = None
    if dirpath:
        if not os.path.isfile(os.path.join(dirpath, "params.npz")):
            raise FileNotFoundError(
                f"{dirpath}: no params.npz (the port loads params.npz bundles "
                f"only; give no directory for random-init weights)")
        full_cfg_path = os.path.join(dirpath, "model_config.json")
        cfg_path = os.path.join(dirpath, "tts.json")
        if os.path.exists(full_cfg_path):
            with open(full_cfg_path) as f:
                cfg = _dataclass_from_dict(TTSConfig, json.load(f))
        elif os.path.exists(cfg_path):
            cfg = load_tts_json(cfg_path)
        params = load_params(os.path.join(dirpath, "params.npz"))
        idx_path = os.path.join(dirpath, "unicode_indexer.json")
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                indexer = np.asarray(json.load(f), np.int64)
        sd = os.path.join(dirpath, "voice_styles")
        if os.path.isdir(sd):
            style_dir = sd
    if params is None:
        params = init_all(seed, cfg)
    if indexer is None:
        indexer = build_default_indexer()
    return Assets(cfg, params, UnicodeProcessor(indexer), style_dir)
