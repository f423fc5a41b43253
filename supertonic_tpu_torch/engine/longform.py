"""Long-form orchestration over the ``infer_batch`` primitive, the
counterpart of ``supertonic_tpu.engine.longform``: chunk the text,
synthesize all chunks as one batch, stitch.

Requirements on the host class: ``infer_batch(texts, langs, style,
total_step, speed) -> (wav [B, T], dur [B])`` and ``self.cfg.sample_rate``.
"""

from __future__ import annotations

import numpy as np

from ..frontend import chunk_text, max_len_for_lang
from . import stitch


class LongFormSynthesis:
    def __call__(self, text: str, lang: str, style, total_step: int = 5,
                 speed: float = 1.05, silence_duration: float = 0.3,
                 crossfade_duration: float = 0.0):
        """Single-utterance long-form synthesis. Returns (wav [1, T] np,
        duration [1] np)."""
        if style.batch != 1:
            raise ValueError("Single speaker text to speech only supports single style")
        chunks = chunk_text(text, max_len=max_len_for_lang(lang))
        if not chunks:
            return np.zeros((1, 0), np.float32), np.zeros((1,), np.float32)
        n = len(chunks)
        wavs, durs = self.infer_batch(chunks, [lang] * n, style.tile(n),
                                      total_step, speed)
        joined, total = stitch.stitch(
            [wavs[i] for i in range(n)], [float(durs[i]) for i in range(n)],
            self.cfg.sample_rate, silence_duration=silence_duration,
            crossfade_duration=crossfade_duration)
        return joined[None, :], np.array([total], np.float32)

    def batch(self, text_list: list[str], lang_list: list[str], style,
              total_step: int = 5, speed: float = 1.05):
        return self.infer_batch(text_list, lang_list, style, total_step, speed)

    def trim(self, wav: np.ndarray, duration: np.ndarray) -> list[np.ndarray]:
        sr = self.cfg.sample_rate
        return [wav[b, : int(sr * float(np.atleast_1d(duration)[b]))]
                for b in range(wav.shape[0])]
