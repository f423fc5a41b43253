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
        (default: the 66M ``TTSConfig()``)."""
        from .assets import load_assets
        from .engine import resolve_device

        device = resolve_device(device)  # fail before building anything
        self.assets = load_assets(assets_dir, seed=seed, cfg=cfg)
        self.cfg = self.assets.cfg
        self.engine = SynthesisEngine(self.assets.params, self.cfg,
                                      self.assets.processor,
                                      precision=precision, seed=seed,
                                      egress_format=egress_format,
                                      device=device)

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
