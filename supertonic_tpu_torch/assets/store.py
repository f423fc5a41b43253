"""Asset bundle: param checkpoint, config, unicode indexer, voice styles —
the counterpart of ``supertonic_tpu.assets.store``.

Layout of an assets directory (``<dir>/``):
    params.npz            flattened JAX-layout param tree ('/'-joined keys)
    tts.json              reference-format config
    model_config.json     full config (written by the JAX package's save_assets)
    unicode_indexer.json  dense codepoint -> id table
    voice_styles/XX.json  reference-format style files

With no directory, ``load_assets`` makes deterministic random-init params
(the JAX package's ``init_all``, bit for bit). A directory must hold
``params.npz``, unless the caller serves it through the ONNX graph backend
(``init_params=False``: ``TTS`` for a directory of the four graphs); the
port never serves random weights in place of a missing checkpoint. The
built-in indexer and synthetic styles stand in for the other missing
pieces.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..config import (TTSConfig, VOICE_PRESETS, _dataclass_from_dict,
                      load_tts_json, to_reference_dict)
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


def save_voice_style(path: str, style: VoiceStyle, index: int = 0) -> None:
    """Write row ``index`` of ``style`` as a reference-format style file."""
    ttl = style.ttl[index]
    dp = style.dp[index]
    data = {
        "style_ttl": {"data": ttl[None].tolist(), "dims": [1, *ttl.shape],
                      "type": "float32"},
        "style_dp": {"data": dp[None].tolist(), "dims": [1, *dp.shape],
                     "type": "float32"},
    }
    with open(path, "w") as f:
        json.dump(data, f)


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


def save_assets(dirpath: str, cfg: TTSConfig, params: Any,
                indexer: np.ndarray | None = None,
                styles: dict[str, VoiceStyle] | None = None) -> None:
    """Write a bundle ``load_assets`` reads: params.npz, tts.json, the full
    config as model_config.json (tts.json carries no layer counts or
    widths), unicode_indexer.json and voice_styles/ (synthetic presets
    when ``styles`` is None). The JAX package's ``save_assets``, file for
    file."""
    import dataclasses

    os.makedirs(dirpath, exist_ok=True)
    save_params(os.path.join(dirpath, "params.npz"), params)
    with open(os.path.join(dirpath, "tts.json"), "w") as f:
        json.dump(to_reference_dict(cfg), f)
    with open(os.path.join(dirpath, "model_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    idx = indexer if indexer is not None else build_default_indexer()
    with open(os.path.join(dirpath, "unicode_indexer.json"), "w") as f:
        json.dump(np.asarray(idx).tolist(), f)
    sd = os.path.join(dirpath, "voice_styles")
    os.makedirs(sd, exist_ok=True)
    for name, st in (styles or synthesize_default_styles(cfg)).items():
        save_voice_style(os.path.join(sd, f"{name}.json"), st)


def load_assets(dirpath: str | None = None, *, seed: int = 0,
                cfg: TTSConfig | None = None, init_params: bool = True) -> Assets:
    """Load the asset bundle at ``dirpath``; with no ``dirpath``,
    random-init params from ``seed``. ``cfg`` is used when there is no
    directory or it holds no config. ``init_params=False`` is for a
    directory served through the ONNX graph backend: no params are loaded
    or made (``Assets.params`` is None). Otherwise the directory must hold
    ``params.npz``. ``TTS_NATIVE_FRONTEND=1`` selects the C++ text frontend
    (``frontend.native``) when it builds."""
    cfg = cfg or TTSConfig()
    params = indexer = style_dir = None
    if dirpath:
        has_params = os.path.isfile(os.path.join(dirpath, "params.npz"))
        if init_params and not has_params:
            raise FileNotFoundError(
                f"{dirpath}: neither params.npz nor the four ONNX graphs "
                f"(give no directory for random-init weights)")
        full_cfg_path = os.path.join(dirpath, "model_config.json")
        cfg_path = os.path.join(dirpath, "tts.json")
        if os.path.exists(full_cfg_path):
            with open(full_cfg_path) as f:
                cfg = _dataclass_from_dict(TTSConfig, json.load(f))
        elif os.path.exists(cfg_path):
            cfg = load_tts_json(cfg_path)
        if has_params and init_params:
            params = load_params(os.path.join(dirpath, "params.npz"))
        idx_path = os.path.join(dirpath, "unicode_indexer.json")
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                indexer = np.asarray(json.load(f), np.int64)
        sd = os.path.join(dirpath, "voice_styles")
        if os.path.isdir(sd):
            style_dir = sd
    if params is None and init_params:
        params = init_all(seed, cfg)
    if indexer is None:
        indexer = build_default_indexer()
    if os.getenv("TTS_NATIVE_FRONTEND", "0") != "0":
        # the C++ frontend (GIL-free normalization and tokenization), as in
        # the JAX package; the Python one when it cannot be built
        from ..frontend.native import best_processor

        return Assets(cfg, params, best_processor(indexer), style_dir)
    return Assets(cfg, params, UnicodeProcessor(indexer), style_dir)
