"""Host-side synthesis engine, the counterpart of
``supertonic_tpu.engine.engine``:

  * (B, L, T) bucket ladders bound the shapes the device sees;
  * long-form chunks are synthesized as ONE batch;
  * the latent bucket comes from a learned seconds-per-character estimate
    (per text-length bucket, kept in memory), and a batch whose predicted
    duration overflows it is re-run at the bucket it needs;
  * noise is drawn on the device from the engine's ``torch.Generator``
    (production) or injected (parity path).

``infer_batch_begin`` dispatches and ``infer_batch_end`` resolves; in this
version they resolve synchronously.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..config import TTSConfig
from ..frontend import UnicodeProcessor
from . import buckets, synthesis
from .longform import LongFormSynthesis


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Without a card, and with no device asked for, it raises;
    it never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def _tree_has_key(tree, key: str) -> bool:
    if isinstance(tree, dict):
        return key in tree or any(_tree_has_key(v, key) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_tree_has_key(v, key) for v in tree)
    return False


def _check_batch(text_list, style) -> None:
    if len(text_list) != style.batch:
        raise ValueError(f"Number of texts ({len(text_list)}) must match number "
                         f"of style vectors ({style.batch})")


@dataclasses.dataclass
class VoiceStyle:
    """Pre-computed style tensors: ttl [B, S, D], dp [B, S_dp, D_dp]."""

    ttl: np.ndarray
    dp: np.ndarray

    @property
    def batch(self) -> int:
        return self.ttl.shape[0]

    def fingerprint(self) -> bytes:
        """Content digest (cached per object), the key of the engine's
        device style cache."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            h.update(np.ascontiguousarray(self.ttl).view(np.uint8))
            h.update(np.ascontiguousarray(self.dp).view(np.uint8))
            fp = self._fp = h.digest()
        return fp

    def tile(self, n: int) -> "VoiceStyle":
        if self.batch != 1:
            raise ValueError(f"tile needs a single style, got {self.batch}")
        return VoiceStyle(np.repeat(self.ttl, n, 0), np.repeat(self.dp, n, 0))


@dataclasses.dataclass
class PendingBatch:
    """A dispatched fused-synthesis batch (infer_batch_begin): the device
    results plus what infer_batch_end needs to resolve and re-run."""

    wav_dev: torch.Tensor
    dur_dev: torch.Tensor
    dev_args: tuple
    text_mask: np.ndarray
    b_true: int
    t_bucket: int
    n_xfer: int
    total_step: int
    speed: float


class SynthesisEngine(LongFormSynthesis):
    def __init__(self, params, cfg: TTSConfig, processor: UnicodeProcessor, *,
                 precision: str | None = None, seed: int = 0, device=None):
        """``params``: the JAX-layout numpy param tree (loaded here onto
        ``device`` in the compute dtype) or modules from
        ``models.load_params``. ``precision="int8"`` quantizes a numpy tree
        that holds no ``w_q`` yet (``models.quantize_params``); the params
        stay unfused, as in the JAX engine. ``device`` defaults to ``cuda``
        and raises when there is no card; pass ``device="cpu"`` for the
        plain path."""
        from ..models import load_params, quantize_params

        self.device = resolve_device(device)
        self.cfg = cfg
        self.processor = processor
        self.precision = precision or cfg.runtime.precision
        self.dtype = synthesis.dtype_of(self.precision)
        if not isinstance(params, torch.nn.Module):
            if self.precision == "int8" and not _tree_has_key(params, "w_q"):
                params = quantize_params(params)
            params = load_params(params, device=self.device, dtype=self.dtype)
        self.params = params
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.stats = {"bucket_overflows": 0}
        # learned seconds-per-char per text-length bucket: window max times
        # a margin picks the latent bucket; an overflow re-runs
        self._spc_windows: dict[int, deque] = {}
        self._spc_default_prior = 1.0 / 11.0
        self._spc_margin = 1.05
        self._style_dev_cache: dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    # learned speaking rate (in memory)
    # ------------------------------------------------------------------

    def _spc_window_for(self, l_bucket: int) -> deque:
        w = self._spc_windows.get(l_bucket)
        if w is None:
            # rates fall with text length: inherit the largest smaller
            # bucket's estimate, else the conservative default
            smaller = [b for b in self._spc_windows if b <= l_bucket]
            prior = (max(self._spc_windows[max(smaller)]) if smaller
                     else self._spc_default_prior)
            w = self._spc_windows[l_bucket] = deque([prior], maxlen=16)
        return w

    def _spc_estimate(self, l_bucket: int) -> float:
        return max(self._spc_window_for(l_bucket))

    def _observe_rate(self, l_bucket: int, obs_spc: float) -> None:
        self._spc_window_for(l_bucket).append(obs_spc)

    def _pin_rate(self, rate: float = 1.0 / 11.0) -> None:
        """Test hook: force a uniform learned rate for every bucket."""
        self._spc_windows = {}
        self._spc_default_prior = rate

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def _pad_batch(self, arrs: list[np.ndarray], b_bucket: int) -> list[np.ndarray]:
        """Pad the batch dim by repeating row 0 (sliced off after compute)."""
        out = []
        for a in arrs:
            b = a.shape[0]
            if b < b_bucket:
                a = np.concatenate([a, np.repeat(a[:1], b_bucket - b, axis=0)], 0)
            out.append(a)
        return out

    def _device_style(self, style: VoiceStyle, b_bucket: int):
        """Batch-padded (style_dp, style_ttl) on the device, cached by
        content fingerprint and bucket (LRU, 32 entries)."""
        key = (style.fingerprint(), b_bucket)
        hit = self._style_dev_cache.pop(key, None)
        if hit is None:
            ttl, dp = self._pad_batch([style.ttl, style.dp], b_bucket)
            hit = (torch.as_tensor(dp, dtype=torch.float32).to(self.device),
                   torch.as_tensor(ttl, dtype=torch.float32).to(self.device))
            while len(self._style_dev_cache) >= 32:
                self._style_dev_cache.pop(next(iter(self._style_dev_cache)))
        self._style_dev_cache[key] = hit  # newest last
        return hit

    def _prepare_inputs(self, text_list, lang_list, style):
        """Frontend + bucketing + device placement. Returns (dev_args,
        text_mask, l_true, b_true, b_bucket)."""
        rt = self.cfg.runtime
        b_true = len(text_list)
        text_ids, text_mask3 = self.processor(text_list, lang_list)
        l_true = text_ids.shape[1]
        pad_l = buckets.pick_bucket(l_true, rt.text_buckets) - l_true
        text_ids = np.pad(text_ids, ((0, 0), (0, pad_l)))
        text_mask = np.pad(text_mask3[:, 0, :], ((0, 0), (0, pad_l)))
        b_bucket = buckets.pick_bucket(b_true, rt.batch_buckets)
        text_ids, text_mask = self._pad_batch([text_ids, text_mask], b_bucket)
        ids_dev = torch.as_tensor(text_ids, dtype=torch.int64).to(self.device)
        mask_dev = torch.as_tensor(text_mask, dtype=torch.float32).to(self.device)
        sdp_dev, sttl_dev = self._device_style(style, b_bucket)
        return (ids_dev, mask_dev, sdp_dev, sttl_dev), text_mask, l_true, b_true, b_bucket

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    def infer_batch(self, text_list, lang_list, style: VoiceStyle,
                    total_step: int = 5, speed: float = 1.05,
                    noise: np.ndarray | None = None):
        """Synthesize a batch. Returns (wav [B, n] f32 numpy, padded: trim
        to int(sr * duration[b]), and duration [B] f32). With ``noise``
        ([B, T, C]) the injected-noise parity path runs instead."""
        _check_batch(text_list, style)
        if not text_list:
            return np.zeros((0, 0), np.float32), np.zeros((0,), np.float32)
        if noise is not None:
            dev_args, _mask, _l, b_true, b_bucket = self._prepare_inputs(
                text_list, lang_list, style)
            return self._infer_injected_noise(dev_args, noise, b_true, b_bucket,
                                              total_step, speed)
        return self.infer_batch_end(self.infer_batch_begin(
            text_list, lang_list, style, total_step, speed))

    def _fused(self, dev_args, total_step: int, t_bucket: int, speed: float):
        with torch.inference_mode():
            return synthesis.synthesize_fused(
                self.params, self.cfg, *dev_args, self.generator, speed,
                int(total_step), int(t_bucket), precision=self.precision)

    def infer_batch_begin(self, text_list, lang_list, style: VoiceStyle,
                          total_step: int = 5, speed: float = 1.05) -> PendingBatch:
        """Dispatch a fused-synthesis batch at the latent bucket the learned
        rate predicts."""
        _check_batch(text_list, style)
        if not text_list:
            raise ValueError("infer_batch_begin requires a non-empty batch")
        if not speed > 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        dev_args, text_mask, l_true, b_true, _bb = self._prepare_inputs(
            text_list, lang_list, style)
        est_secs = (l_true * self._spc_estimate(text_mask.shape[1])
                    * self._spc_margin / min(speed, 1.0))
        t_bucket = buckets.pick_bucket(
            buckets.latent_len_for_duration(est_secs, sr, chunk), rt.latent_buckets)
        # the transferred slice uses a leaner margin than the bucket choice
        t_slice = buckets.latent_len_for_duration(
            est_secs * (1.04 / self._spc_margin), sr, chunk)
        n_xfer = min(t_bucket, buckets.quantize_up(max(t_slice, 1), 8))
        wav_dev, dur_dev = self._fused(dev_args, total_step, t_bucket, speed)
        return PendingBatch(wav_dev=wav_dev, dur_dev=dur_dev, dev_args=dev_args,
                            text_mask=text_mask, b_true=b_true, t_bucket=t_bucket,
                            n_xfer=n_xfer, total_step=total_step, speed=speed)

    def infer_batch_end(self, pending: PendingBatch):
        """Resolve a dispatch: fetch the duration, re-run at a larger bucket
        on overflow, update the learned rate, fetch the waveform."""
        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        b_true = pending.b_true
        wav_dev, dur_dev = pending.wav_dev, pending.dur_dev
        t_bucket, n_xfer = pending.t_bucket, pending.n_xfer
        for _ in range(4):
            dur = dur_dev.cpu().numpy()
            t_needed = int(((dur[:b_true] * sr).astype(np.int64).max()
                            + chunk - 1) // chunk)
            if t_needed <= t_bucket:
                break
            self.stats["bucket_overflows"] += 1
            t_bucket = buckets.pick_bucket(t_needed, rt.latent_buckets)
            n_xfer = min(t_bucket, buckets.quantize_up(t_needed, 8))
            wav_dev, dur_dev = self._fused(pending.dev_args, pending.total_step,
                                           t_bucket, pending.speed)
        else:
            # duration is deterministic per input, so one re-run always fits
            raise RuntimeError(
                f"latent bucket overflow persisted after retries (needed "
                f"{t_needed} > bucket {t_bucket}); refusing to return "
                f"truncated audio")
        row_chars = np.maximum(pending.text_mask[:b_true].sum(axis=1), 1.0)
        self._observe_rate(pending.text_mask.shape[1],
                           float((dur[:b_true] * pending.speed / row_chars).max()))
        wav = wav_dev[:b_true, : max(n_xfer, t_needed) * chunk]
        # a pinned host buffer (PyTorch caches them) copies several times
        # faster than the pageable memory .cpu() would copy into
        host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=wav.is_cuda)
        host.copy_(wav)
        # int16 egress decoded with torch's threaded kernels
        return host.float().div_(32767.0).numpy(), dur[:b_true]

    def _infer_injected_noise(self, dev_args, noise, b_true, b_bucket,
                              total_step, speed):
        """Parity path: text stage, a duration sync to size the latent grid
        to the caller's noise, then the acoustic stage."""
        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        ids, mask, sdp, sttl = dev_args
        with torch.inference_mode():
            dur_dev, emb = synthesis.text_stage(
                self.params, self.cfg, ids, mask, sdp, sttl, speed,
                precision=self.precision)
            dur = dur_dev.cpu().numpy()
            latent_lengths = ((dur * sr).astype(np.int64) + chunk - 1) // chunk
            t_bucket = buckets.pick_bucket(int(latent_lengths[:b_true].max()),
                                           rt.latent_buckets)
            latent_mask = (np.arange(t_bucket)[None, :]
                           < latent_lengths[:, None]).astype(np.float32)
            noise_arr = np.zeros((b_bucket, t_bucket, self.cfg.latent_channels),
                                 np.float32)
            t_copy = min(noise.shape[1], t_bucket)
            noise_arr[: noise.shape[0], :t_copy] = noise[:, :t_copy]
            wav = synthesis.acoustic_stage(
                self.params, self.cfg, emb, sttl, mask,
                torch.as_tensor(latent_mask).to(self.device),
                torch.as_tensor(noise_arr).to(self.device), int(total_step),
                precision=self.precision)
        return wav[:b_true].cpu().numpy(), dur[:b_true]
