"""Serving adapter: the ONNX graph-executor backend behind the engine API,
the counterpart of ``supertonic_tpu.engine.onnx_adapter``.

``TTS`` serves a directory of the four reference graphs through this
adapter when ``TTS_ONNX_FUSED=0`` or when the graphs cannot be composed
into the fused backend (``OnnxStageBackend.validate`` fails). It exposes
the part of the SynthesisEngine surface the serving stack uses —
``__call__`` / ``batch`` / ``stream`` / ``infer_batch`` (+ begin/end for
the continuous batcher) / ``trim`` / ``to_host`` / ``profiler`` — over
``assets.OnnxPipeline``, whose executors run eagerly, each graph call on
its own (3 + total_step calls per batch, like the reference's ORT calls).
Convert the bundle (``python -m supertonic_tpu_torch.assets.convert_onnx``)
to serve the native engine instead.
"""

from __future__ import annotations

import time

import numpy as np

from ..config import TTSConfig
from ..utils.timing import StageProfiler
from .longform import LongFormSynthesis


class OnnxEngineAdapter(LongFormSynthesis):
    """SynthesisEngine-shaped facade over assets.OnnxPipeline."""

    def __init__(self, pipeline, cfg: TTSConfig):
        self.pipeline = pipeline
        self.cfg = cfg
        self.precision = "f32"  # executor runs reference-strict f32 matmuls
        self.device = pipeline.vocoder.device
        self.profiler = StageProfiler()

    # ------------------------------------------------------------- core
    def infer_batch(
        self,
        text_list: list[str],
        lang_list: list[str],
        style,
        total_step: int = 5,
        speed: float = 1.05,
        noise: np.ndarray | None = None,
        device_output: bool = False,
        pre_normalized: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        if not text_list:
            return (np.zeros((0, 0), np.float32), np.zeros((0,), np.float32))
        t0 = time.perf_counter()
        with self.profiler.stage("onnx_pipeline"):
            if noise is not None:
                wav, dur = self.pipeline._infer(
                    text_list, lang_list, style, total_step, speed,
                    noise=noise)
            else:
                wav, dur = self.pipeline._infer(
                    text_list, lang_list, style, total_step, speed,
                    pre_normalized=pre_normalized)
        wav = np.asarray(wav)
        dur = np.asarray(dur, np.float32)
        audio_s = float(np.sum(dur))
        n_chars = sum(len(t) for t in text_list)
        record = (self.profiler.record_throughput if device_output
                  else self.profiler.record_result)
        record(audio_s, n_chars, time.perf_counter() - t0)
        return wav, dur

    # the batcher's begin/end pipelining protocol: the executor backend has
    # no split dispatch (each graph is its own synchronous program), so
    # begin computes eagerly and end unwraps
    def infer_batch_begin(self, text_list, lang_list, style,
                          total_step: int = 5, speed: float = 1.05, *,
                          device_output: bool = False,
                          pre_normalized: bool = False):
        return self.infer_batch(text_list, lang_list, style, total_step,
                                speed, device_output=device_output,
                                pre_normalized=pre_normalized)

    def infer_batch_end(self, pending):
        return pending

    # ------------------------------------------------- reference API shape
    # __call__ / batch / stream / trim come from LongFormSynthesis (shared
    # with SynthesisEngine — no drift between the two live serving paths)

    def infer_with_progress(self, text, lang, style, total_step: int = 5,
                            speed: float = 1.05, progress_callback=None):
        """Single-utterance synthesis with a per-denoise-step callback
        (reference web port behavior): the pipeline runs its Euler loop a
        step at a time on the host anyway, so this costs nothing."""
        if style.batch != 1:
            raise ValueError("infer_with_progress takes a single style")
        return self.pipeline._infer(
            [text], [lang], style, total_step, speed,
            progress_callback=progress_callback)

    def warmup(self, *, total_steps=(2, 5), progress=None, **_kw) -> int:
        """Run the smallest bucket once per step count (the executors'
        device constants and the libraries' first calls)."""
        style = self._default_style()
        n = 0
        for steps in total_steps:
            self.infer_batch(["Warm up."], ["en"], style, total_step=steps,
                             device_output=True)
            n += 1
            if progress:
                progress(n, len(total_steps))
        return n

    def _default_style(self):
        from .engine import VoiceStyle

        rng = np.random.default_rng(0)
        s_ttl, s_dp = self.cfg.ttl.style, self.cfg.dp.style
        return VoiceStyle(
            rng.standard_normal(
                (1, s_ttl.n_style, s_ttl.style_value_dim)).astype(np.float32),
            rng.standard_normal(
                (1, s_dp.n_style, s_dp.style_value_dim)).astype(np.float32),
        )

    # ------------------------------------------------------------ helpers
    def to_host(self, wav, ready=None) -> np.ndarray:
        return np.asarray(wav)
