"""Reference-compatible API layer, the counterpart of
``supertonic_tpu.compat``.

Drop-in surface for code written against the reference's Python helper
(reference py/helper.py): same class names, same call signatures, same
tensor layouts, backed by the port's engine on the card.

    from supertonic_tpu_torch.compat import (
        load_text_to_speech, load_voice_style, chunk_text, TextToSpeech)

    tts = load_text_to_speech("assets")          # py/helper.py:322-336
    style = load_voice_style(["voice_styles/M1.json"])
    wav, dur = tts(text, "en", style, total_step=5, speed=1.05)
    wav, dur = tts.batch(texts, langs, style, 5)

Layout notes: the reference feeds and returns channel-first latents
[B, C, T] and masks [B, 1, L]; these wrappers accept and return those
layouts and translate to the engine's [B, T, C]. The per-network ``run_*``
entry points compute in f32, as the reference's ONNX sessions do.
"""

from __future__ import annotations

import numpy as np
import torch

from .assets import load_assets, load_voice_style as _load_style_files
from .config import AVAILABLE_LANGS  # noqa: F401  (re-export, py/helper.py:13)
from .engine import SynthesisEngine, VoiceStyle
from .frontend import chunk_text  # noqa: F401  (re-export, py/helper.py:388)
from .frontend import UnicodeProcessor as _Processor
from .frontend import length_to_mask, get_latent_mask  # noqa: F401
from .utils import sanitize_filename, timer  # noqa: F401  (py/helper.py:370-385)


class UnicodeProcessor(_Processor):
    """Reference-layout processor: __call__ returns mask [B, 1, L]
    (py/helper.py:117-131). The engine-native class returns the same; it
    is re-exported here under the reference name."""


class Style(VoiceStyle):
    """Reference name for the style pair (py/helper.py:134-138)."""

    def __init__(self, style_ttl_onnx: np.ndarray, style_dp_onnx: np.ndarray):
        super().__init__(np.asarray(style_ttl_onnx), np.asarray(style_dp_onnx))


def load_voice_style(voice_style_paths: list[str], verbose: bool = False) -> Style:
    vs = _load_style_files(voice_style_paths, verbose)
    return Style(vs.ttl, vs.dp)


class TextToSpeech:
    """Reference TextToSpeech surface (py/helper.py:140-254) over the
    engine. ``__call__(text, lang, style, total_step, speed,
    silence_duration)`` and ``batch(...)`` match exactly; ``sample_rate``
    and the ``cfgs`` attributes mirror the originals.

    ``params``: the f32 numpy param tree the engine was built from. The
    ``run_*`` entry points compute in f32; an engine of another precision
    holds its weights rounded, so they load an f32 copy of ``params`` on
    first use (without ``params``, the engine's weights upcast)."""

    def __init__(self, engine: SynthesisEngine, cfgs: dict | None = None, *,
                 params=None):
        self.engine = engine
        self.cfgs = cfgs or {}
        self.sample_rate = engine.cfg.sample_rate
        self.base_chunk_size = engine.cfg.ae.base_chunk_size
        self.chunk_compress_factor = engine.cfg.ttl.chunk_compress_factor
        self.ldim = engine.cfg.ttl.latent_dim
        self._tree = params
        self._f32 = None

    def __call__(
        self,
        text: str,
        lang: str,
        style: VoiceStyle,
        total_step: int,
        speed: float = 1.05,
        silence_duration: float = 0.3,
    ) -> tuple[np.ndarray, np.ndarray]:
        assert style.ttl.shape[0] == 1, (
            "Single speaker text to speech only supports single style"
        )
        return self.engine(text, lang, style, total_step, speed, silence_duration)

    def batch(
        self,
        text_list: list[str],
        lang_list: list[str],
        style: VoiceStyle,
        total_step: int,
        speed: float = 1.05,
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.engine.batch(text_list, lang_list, style, total_step, speed)

    # ------------------------------------------------------------------
    # per-network access in the reference's ONNX session layout
    # ------------------------------------------------------------------

    def _params(self):
        """The f32 parameter modules the ``run_*`` entry points use."""
        if self.engine.precision == "f32":
            return self.engine.params
        if self._f32 is None:
            from .models import load_params, to_numpy_tree

            tree = self._tree if self._tree is not None else to_numpy_tree(
                self.engine.params)
            self._f32 = load_params(tree, device=self.engine.device,
                                    dtype=torch.float32)
        return self._f32

    def _dev(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.engine.device, dtype=dtype)

    def _mask(self, mask3) -> torch.Tensor:
        return self._dev(np.asarray(mask3)[:, 0, :])

    def run_duration_predictor(self, text_ids, style_dp, text_mask):
        """feeds/outputs per SURVEY.md §2.2: text_ids i64 [B,L], style_dp
        [B,S,D], text_mask [B,1,L] -> duration f32 [B]."""
        from .models import duration_predictor

        with torch.inference_mode():
            dur = duration_predictor.apply(
                self._params()["duration_predictor"], self.engine.cfg,
                self._dev(text_ids, torch.int64), self._dev(style_dp),
                self._mask(text_mask))
            return dur.cpu().numpy()

    def run_text_encoder(self, text_ids, style_ttl, text_mask):
        from .models import text_encoder

        with torch.inference_mode():
            emb = text_encoder.apply(
                self._params()["text_encoder"], self.engine.cfg,
                self._dev(text_ids, torch.int64), self._dev(style_ttl),
                self._mask(text_mask))
            return emb.cpu().numpy()

    def run_vector_estimator(self, noisy_latent, text_emb, style_ttl,
                             text_mask, latent_mask, current_step, total_step):
        """noisy_latent [B, C, T] channel-first like the ONNX graph."""
        from .models import vector_estimator

        with torch.inference_mode():
            x = self._dev(np.transpose(np.asarray(noisy_latent), (0, 2, 1)))
            out = vector_estimator.step(
                self._params()["vector_estimator"], self.engine.cfg, x,
                self._dev(text_emb), self._dev(style_ttl), self._mask(text_mask),
                self._mask(latent_mask), self._dev(current_step),
                self._dev(total_step), fused_ffn=self.engine.fused_ffn)
            return np.transpose(out.cpu().numpy(), (0, 2, 1))

    def run_vocoder(self, latent):
        """latent [B, C, T] -> wav [B, T*chunk] (SURVEY.md §2.2)."""
        from .models import vocoder

        with torch.inference_mode():
            x = self._dev(np.transpose(np.asarray(latent), (0, 2, 1)))
            return vocoder.apply(self._params()["vocoder"], self.engine.cfg, x,
                                 up_matmul=self.engine.up_matmul,
                                 fused_resblocks=self.engine.fused_resblocks).cpu().numpy()


def load_text_to_speech(assets_dir: str | None = None,
                        use_gpu: bool = False, *,
                        backend: str = "auto", device=None):
    """Reference loader shape (py/helper.py:322-336). ``use_gpu`` is accepted
    for signature parity and ignored: the port runs on the card unless
    ``device="cpu"`` asks for the CPU.

    ``backend``:
      * "native": the port's models over a converted params bundle (a
        directory without ``params.npz`` raises; no directory gives
        random-init weights).
      * "onnx": the port's graph executor running the four .onnx files
        from ``assets_dir`` (or its ``onnx/``), per call.
      * "auto": "onnx" when ``assets_dir`` holds the four graphs but no
        ``params.npz``, else "native".
    """
    import os

    graphs_dir = None
    if backend in ("auto", "onnx") and assets_dir:
        has_params = os.path.exists(os.path.join(assets_dir, "params.npz"))
        if backend == "onnx" or not has_params:
            # the flattened and the assets/onnx bundle layouts, as
            # TTS._find_graphs probes them
            for sub in ("", "onnx"):
                d = os.path.join(assets_dir, sub) if sub else assets_dir
                if all(os.path.exists(os.path.join(d, f"{m}.onnx"))
                       for m in ("duration_predictor", "text_encoder",
                                 "vector_estimator", "vocoder")):
                    graphs_dir = d
                    break
        if backend == "auto":
            backend = "onnx" if graphs_dir else "native"
    if backend == "onnx":
        from .assets.onnx_pipeline import load_onnx_pipeline

        return load_onnx_pipeline(graphs_dir or assets_dir, device=device)
    from .engine import resolve_device

    device = resolve_device(device)  # fail before loading anything
    assets = load_assets(assets_dir)
    engine = SynthesisEngine(assets.params, assets.cfg, assets.processor, device=device)
    from .config import to_reference_dict

    return TextToSpeech(engine, to_reference_dict(assets.cfg), params=assets.params)
