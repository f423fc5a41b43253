"""Long-form orchestration over the ``infer_batch`` primitive, the
counterpart of ``supertonic_tpu.engine.longform``: chunk the text,
synthesize all chunks as one batch and stitch, or stream them chunk by
chunk (the first chunk in vocoder windows where the host class has
``_vocode_stream``).

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

    def stream(self, text: str, lang: str, style, total_step: int = 5,
               speed: float = 1.05, group_size: int = 2):
        """Long-form streaming: yields (trimmed wav [T] f32, duration s) per
        chunk as soon as it is synthesized. The first group is a single
        chunk (the least time to first audio); later chunks batch up to
        ``group_size``."""
        if style.batch != 1:
            raise ValueError("streaming takes a single style")
        chunks = chunk_text(text, max_len=max_len_for_lang(lang))
        i = 0
        while i < len(chunks):
            n = 1 if i == 0 else group_size
            group = chunks[i: i + n]
            i += len(group)
            wavs, durs = self.infer_batch(group, [lang] * len(group),
                                          style.tile(len(group)), total_step, speed)
            for w, d in zip(self.trim(wavs, durs), durs):
                yield w, float(d)

    def stream_windows(self, text: str, lang: str, style, total_step: int = 5,
                       speed: float = 1.05, group_size: int = 2,
                       window_frames: int = 64):
        """Like :meth:`stream`, but the first chunk's audio leaves in vocoder
        windows, so the first samples reach the host after one window's
        vocoding and copy instead of the whole chunk's. Yields ``(wav [T]
        f32, seconds, chunk_end bool)``; pieces with ``chunk_end=False``
        continue the same chunk (no silence gap belongs between them).
        Interior samples equal full-chunk vocoding (the halo covers the
        vocoder's receptive field, models/vocoder.receptive_field_frames)."""
        if style.batch != 1:
            raise ValueError("streaming takes a single style")
        chunks = chunk_text(text, max_len=max_len_for_lang(lang))
        if not chunks:
            return
        # windows are the native single-device engine's (the graph
        # backend's vocoder is an opaque graph; a mesh engine's rows are
        # split over its shards, as in the JAX engine): others stream whole
        # chunks
        if (window_frames and getattr(self, "backend", None) is None
                and getattr(self, "mesh", None) is None
                and hasattr(self, "_vocode_stream")):
            yield from self._vocode_stream(chunks[0], lang, style, total_step,
                                           speed, window_frames)
        else:
            wavs, durs = self.infer_batch([chunks[0]], [lang], style,
                                          total_step, speed)
            yield self.trim(wavs, durs)[0], float(durs[0]), True
        i = 1
        while i < len(chunks):
            group = chunks[i: i + group_size]
            i += len(group)
            wavs, durs = self.infer_batch(group, [lang] * len(group),
                                          style.tile(len(group)), total_step, speed)
            for w, d in zip(self.trim(wavs, durs), durs):
                yield w, float(d), True

    def trim(self, wav: np.ndarray, duration: np.ndarray) -> list[np.ndarray]:
        sr = self.cfg.sample_rate
        return [wav[b, : int(sr * float(np.atleast_1d(duration)[b]))]
                for b in range(wav.shape[0])]
