"""supertonic_tpu_torch — the Supertonic TTS inference stack in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100 (Hopper, sm_90a).

A port of the JAX package ``supertonic_tpu``, which stays the reference:
same param tree, same inputs, outputs held against it by the tests. The
port never imports JAX or that package.

    from supertonic_tpu_torch import TTS
    tts = TTS()                          # runs on cuda; TTS(device="cpu")
    style = tts.get_voice_style("M4")    # for the plain CPU path
    wav, duration = tts.synthesize("Hello world!", voice_style=style)
    tts.save_audio(wav, "out.wav")
"""

from __future__ import annotations

import numpy as np

from .config import AVAILABLE_LANGS, TTSConfig, VOICE_PRESETS
from .engine import SynthesisEngine, VoiceStyle

__version__ = "0.1.0"


class TTS:
    """High-level synthesizer (the reference's pypi-API shape)."""

    def __init__(self, assets_dir: str | None = None, *,
                 precision: str | None = None, seed: int = 0,
                 egress_format: str = "int16", device=None,
                 cfg: TTSConfig | None = None):
        """``device`` defaults to ``cuda`` and raises when there is no card;
        ``device="cpu"`` runs the plain PyTorch path. ``precision``: "bf16"
        (the config's default), "f32", or "int8" (W8A8 vector-estimator
        block linears, bf16 elsewhere). ``egress_format``: the waveform's
        form on its way to the host, "int16", "mulaw" (8-bit G.711, half the
        bytes) or "f32". ``cfg`` applies when ``assets_dir`` holds no config
        (default: the 66M ``TTSConfig()``).

        A directory (or its ``onnx/``) holding the four reference graphs
        and no ``params.npz`` is served through the ONNX graph executor:
        by default the fused backend under the native engine (buckets,
        learned rate, batcher, one CUDA graph per static key on the card);
        ``TTS_ONNX_FUSED=0``, or graphs that cannot be composed into the
        fused stages (``validate``), select the per-call adapter. Graphs
        whose inputs break the reference contract raise
        ``ContractMismatch``; unreadable graphs raise too: the port never
        serves random weights in their place."""
        import os

        from .assets import load_assets
        from .engine import resolve_device

        device = resolve_device(device)  # fail before building anything
        graphs_dir = self._find_graphs(assets_dir)
        if graphs_dir is not None and graphs_dir != assets_dir and \
                os.path.exists(os.path.join(graphs_dir, "tts.json")):
            # an un-flattened bundle (<dir>/onnx/*): the config and the
            # indexer live next to the graphs
            assets_dir = graphs_dir
        self.assets = load_assets(assets_dir, seed=seed, cfg=cfg,
                                  init_params=graphs_dir is None)
        self.cfg = self.assets.cfg
        if graphs_dir is None:
            self.engine = SynthesisEngine(self.assets.params, self.cfg,
                                          self.assets.processor,
                                          precision=precision, seed=seed,
                                          egress_format=egress_format,
                                          device=device)
        else:
            self.engine = self._graph_engine(graphs_dir, precision, seed,
                                             egress_format, device)

    def _graph_engine(self, graphs_dir: str, precision, seed: int,
                      egress_format: str, device):
        import os

        from .utils.logging import default_logger as log

        mp = ("float32" if (precision or self.cfg.runtime.precision) == "f32"
              else "default")
        if os.environ.get("TTS_ONNX_FUSED", "1") != "0":
            from .assets.onnx_backend import load_onnx_backend

            backend = load_onnx_backend(graphs_dir, self.cfg, matmul_precision=mp,
                                        device=device)
            try:
                # a shape-only run on meta tensors: graphs that cannot
                # compose into the fused stages surface here, and serving
                # degrades to the per-call adapter instead of failing the
                # first live request
                backend.validate()
            except Exception as e:
                log.warning("onnx_fused_backend_untraceable", dir=graphs_dir,
                            error=f"{type(e).__name__}: {e}",
                            fallback="per-call adapter")
            else:
                log.info("serving_onnx_fused_backend", dir=graphs_dir)
                return SynthesisEngine(None, self.cfg, self.assets.processor,
                                       precision=precision, seed=seed,
                                       egress_format=egress_format,
                                       device=device, backend=backend)
        from .assets.onnx_pipeline import load_onnx_pipeline
        from .engine.onnx_adapter import OnnxEngineAdapter

        pipeline = load_onnx_pipeline(graphs_dir, seed=seed, bucketed=True,
                                      matmul_precision=mp, device=device)
        if egress_format != "int16":
            # the adapter always fetches f32 host audio
            log.warning("onnx_adapter_ignores_egress_format",
                        requested=egress_format)
        log.info("serving_onnx_executor_backend", dir=graphs_dir)
        return OnnxEngineAdapter(pipeline, self.cfg)

    @staticmethod
    def _find_graphs(assets_dir: str | None) -> str | None:
        """The directory holding the four reference graphs, when the bundle
        has them and no converted params.npz: ``<dir>`` or ``<dir>/onnx``."""
        import os

        if not assets_dir:
            return None
        if os.path.exists(os.path.join(assets_dir, "params.npz")):
            return None
        graph_names = ("duration_predictor", "text_encoder",
                       "vector_estimator", "vocoder")
        for sub in ("", "onnx"):
            d = os.path.join(assets_dir, sub) if sub else assets_dir
            if all(os.path.exists(os.path.join(d, f"{g}.onnx"))
                   for g in graph_names):
                return d
        return None

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    def get_voice_style(self, voice_name: str = "M1") -> VoiceStyle:
        return self.assets.get_voice_style(voice_name)

    def synthesize(self, text: str, voice_style: VoiceStyle, lang: str = "en",
                   total_step: int = 5, speed: float = 1.05,
                   silence_duration: float = 0.3,
                   crossfade_duration: float = 0.0):
        """Returns (wav [1, n_samples], duration [1]) like the reference."""
        return self.engine(text, lang, voice_style, total_step, speed,
                           silence_duration, crossfade_duration)

    def synthesize_batch(self, texts: list[str], langs: list[str],
                         voice_style: VoiceStyle, total_step: int = 5,
                         speed: float = 1.05):
        return self.engine.batch(texts, langs, voice_style, total_step, speed)

    def save_audio(self, wav: np.ndarray, path: str) -> None:
        from .utils import write_wav

        write_wav(path, np.asarray(wav).reshape(-1), self.sample_rate)


__all__ = [
    "AVAILABLE_LANGS",
    "SynthesisEngine",
    "TTS",
    "TTSConfig",
    "VOICE_PRESETS",
    "VoiceStyle",
    "__version__",
]
