"""Reference-graph inference pipeline on the generic ONNX executor, the
counterpart of ``supertonic_tpu.assets.onnx_pipeline``.

This is the alternate model backend behind the SURVEY.md §2.2 call-site
contract: point it at a directory holding the four real ONNX graphs
(duration_predictor / text_encoder / vector_estimator / vocoder.onnx,
reference py/helper.py:289-306) plus ``tts.json`` and
``unicode_indexer.json``, and it reproduces the reference ``TextToSpeech``
orchestration (py/helper.py:140-254) op by op in PyTorch — no
architecture knowledge, no weight mapping table. Real-weight parity becomes
a data drop: mount the Hugging Face assets, run this, diff waveforms.

Noise is an explicit input (``noise=`` or a seeded ``np.random``), matching
the reference's noise-as-input design (py/helper.py:161-175) so the same
noise can be fed to onnxruntime and to this executor for bit-faithful
comparison.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..frontend import (UnicodeProcessor, chunk_text, get_latent_mask,
                        max_len_for_lang, preprocess_text)
from .onnx_exec import OnnxExecutor
from .onnx_reader import load_onnx

MODEL_FILES = ("duration_predictor", "text_encoder",
               "vector_estimator", "vocoder")


def load_executors(onnx_dir: str, *, matmul_precision: str = "float32",
                   bf16_storage: bool = False,
                   device=None) -> dict[str, OnnxExecutor]:
    """The four graphs from a reference-layout directory
    (py/helper.py:289-306), one executor each on ``device`` (default
    ``cuda``). Shared by the per-call pipeline below and the fused engine
    backend (onnx_backend)."""
    execs = {}
    for name in MODEL_FILES:
        path = os.path.join(onnx_dir, f"{name}.onnx")
        execs[name] = OnnxExecutor(load_onnx(path),
                                   matmul_precision=matmul_precision,
                                   bf16_storage=bf16_storage, device=device)
    return execs


class OnnxPipeline:
    """Mirror of the reference TextToSpeech (py/helper.py:140-254) with the
    four ORT sessions replaced by graph executors. Noise comes from a
    seeded ``np.random`` on the host, so a seed gives the JAX pipeline's
    noise bit for bit."""

    def __init__(self, cfgs: dict, processor: UnicodeProcessor,
                 dp: OnnxExecutor, text_enc: OnnxExecutor,
                 vector_est: OnnxExecutor, vocoder: OnnxExecutor,
                 *, seed: int = 0,
                 text_buckets: tuple[int, ...] | None = None,
                 latent_buckets: tuple[int, ...] | None = None):
        """``text_buckets``/``latent_buckets``: optional shape ladders. The
        reference runs its graphs at arbitrary (L, T) — fine for ONNX CPU,
        but a bounded shape set keeps the executors' device caches bounded.
        With ladders, L and
        T pad up to bucket boundaries (masks keep results identical to
        unpadded execution — the real graphs are mask-driven by design)."""
        self.cfgs = cfgs
        self.processor = processor
        self.dp = dp
        self.text_enc = text_enc
        self.vector_est = vector_est
        self.vocoder = vocoder
        self.sample_rate = cfgs["ae"]["sample_rate"]
        self.base_chunk_size = cfgs["ae"]["base_chunk_size"]
        self.chunk_compress_factor = cfgs["ttl"]["chunk_compress_factor"]
        self.ldim = cfgs["ttl"]["latent_dim"]
        self.text_buckets = text_buckets
        self.latent_buckets = latent_buckets
        self._rng = np.random.default_rng(seed)

    # reference py/helper.py:161-175 (+ optional latent-bucket padding)
    def sample_noisy_latent(
        self, duration: np.ndarray, noise: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        bsz = len(duration)
        wav_len_max = duration.max() * self.sample_rate
        wav_lengths = (duration * self.sample_rate).astype(np.int64)
        chunk_size = self.base_chunk_size * self.chunk_compress_factor
        latent_len = int((wav_len_max + chunk_size - 1) // chunk_size)
        t_pad = latent_len
        if self.latent_buckets:
            from ..engine.buckets import pick_bucket

            t_pad = pick_bucket(latent_len, self.latent_buckets)
        latent_dim = self.ldim * self.chunk_compress_factor
        if noise is None:
            # draw at the EXACT latent length so a seeded pipeline produces
            # identical audio with or without bucketing (the pad region is
            # masked — zeros there are semantically inert)
            noise = self._rng.standard_normal(
                (bsz, latent_dim, latent_len)).astype(np.float32)
        else:
            noise = np.asarray(noise, np.float32)[:, :, :latent_len]
            if noise.shape != (bsz, latent_dim, latent_len):
                raise ValueError(
                    f"injected noise must cover [{bsz},{latent_dim},"
                    f"{latent_len}], got {noise.shape}")
        if t_pad > latent_len:  # bucket padding is masked: zeros exact
            noise = np.pad(noise, ((0, 0), (0, 0), (0, t_pad - latent_len)))
        latent_mask = get_latent_mask(
            wav_lengths, self.base_chunk_size, self.chunk_compress_factor,
            max_len=t_pad,
        ).astype(np.float32)
        return noise * latent_mask, latent_mask

    # reference py/helper.py:177-215 — the §2.2 I/O contract, verbatim
    def _infer(
        self,
        text_list: list[str],
        lang_list: list[str],
        style,
        total_step: int,
        speed: float = 1.05,
        noise: np.ndarray | None = None,
        progress_callback=None,
        pre_normalized: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        assert len(text_list) == style.ttl.shape[0], (
            "Number of texts must match number of style vectors"
        )
        bsz = len(text_list)
        max_len = None
        if self.text_buckets:
            from ..engine.buckets import pick_bucket

            lengths = [len(t) if pre_normalized else
                       len(preprocess_text(t, g))
                       for t, g in zip(text_list, lang_list)]
            max_len = pick_bucket(max(lengths), self.text_buckets)
        text_ids, text_mask = self.processor(
            text_list, lang_list, max_len=max_len,
            pre_normalized=pre_normalized)
        text_ids = text_ids.astype(np.int64)
        text_mask = text_mask.astype(np.float32)
        (duration,) = self.dp.run(None, {
            "text_ids": text_ids, "style_dp": style.dp,
            "text_mask": text_mask,
        })
        duration = np.asarray(duration, np.float32) / speed
        (text_emb,) = self.text_enc.run(None, {
            "text_ids": text_ids, "style_ttl": style.ttl,
            "text_mask": text_mask,
        })
        xt, latent_mask = self.sample_noisy_latent(duration, noise)
        total_step_np = np.full((bsz,), total_step, np.float32)
        for step in range(total_step):
            (xt,) = self.vector_est.run(None, {
                "noisy_latent": xt,
                "text_emb": text_emb,
                "style_ttl": style.ttl,
                "text_mask": text_mask,
                "latent_mask": latent_mask,
                "current_step": np.full((bsz,), step, np.float32),
                "total_step": total_step_np,
            })
            if progress_callback is not None:
                # per-denoise-step progress (reference web port semantics,
                # web/helper.js:215-218); xt is already a host array, so the
                # step has truly COMPLETED when this fires
                progress_callback(step + 1, total_step)
        (wav,) = self.vocoder.run(None, {"latent": xt})
        wav = np.asarray(wav)
        if self.latent_buckets:
            # cut the bucket padding back to what unbucketed execution
            # returns — __call__ CONCATENATES chunk waveforms (reference
            # py/helper.py:233-244), so pad-region audio must not leak in
            chunk_size = self.base_chunk_size * self.chunk_compress_factor
            wav_len_max = duration.max() * self.sample_rate
            latent_len = int((wav_len_max + chunk_size - 1) // chunk_size)
            wav = wav[:, : latent_len * chunk_size]
        return wav, duration

    # reference py/helper.py:217-244
    def __call__(
        self,
        text: str,
        lang: str,
        style,
        total_step: int = 5,
        speed: float = 1.05,
        silence_duration: float = 0.3,
    ) -> tuple[np.ndarray, np.ndarray]:
        assert style.ttl.shape[0] == 1, (
            "Single speaker text to speech only supports single style"
        )
        wav_cat = dur_cat = None
        for piece in chunk_text(text, max_len=max_len_for_lang(lang)):
            wav, dur = self._infer([piece], [lang], style, total_step, speed)
            if wav_cat is None:
                wav_cat, dur_cat = wav, dur
            else:
                silence = np.zeros(
                    (1, int(silence_duration * self.sample_rate)), np.float32)
                wav_cat = np.concatenate([wav_cat, silence, wav], axis=1)
                dur_cat = dur_cat + dur + silence_duration
        return wav_cat, dur_cat

    def batch(self, text_list, lang_list, style, total_step=5, speed=1.05):
        return self._infer(text_list, lang_list, style, total_step, speed)


def load_onnx_pipeline(onnx_dir: str, *, seed: int = 0,
                       matmul_precision: str = "float32",
                       bucketed: bool = False, device=None) -> OnnxPipeline:
    """Load the four graphs + tts.json + unicode_indexer.json from a
    directory laid out like the reference assets/onnx (py/helper.py:289-319).

    ``bucketed=True`` pads (L, T) up the default runtime ladders, so the
    shapes a server sees stay bounded. ``device`` defaults to ``cuda``."""
    execs = load_executors(onnx_dir, matmul_precision=matmul_precision,
                           device=device)
    with open(os.path.join(onnx_dir, "tts.json")) as f:
        cfgs = json.load(f)
    with open(os.path.join(onnx_dir, "unicode_indexer.json")) as f:
        indexer = np.asarray(json.load(f), np.int64)
    processor = UnicodeProcessor(indexer)
    buckets = {}
    if bucketed:
        from ..config import RuntimeConfig

        rt = RuntimeConfig()
        buckets = dict(text_buckets=rt.text_buckets,
                       latent_buckets=rt.latent_buckets)
    return OnnxPipeline(cfgs, processor,
                        execs["duration_predictor"], execs["text_encoder"],
                        execs["vector_estimator"], execs["vocoder"],
                        seed=seed, **buckets)
