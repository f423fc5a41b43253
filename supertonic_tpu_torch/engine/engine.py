"""Host-side synthesis engine, the counterpart of
``supertonic_tpu.engine.engine``:

  * (B, L, T) bucket ladders bound the shapes the device sees;
  * long-form chunks are synthesized as ONE batch;
  * the latent bucket comes from a learned seconds-per-character estimate
    per text-length bucket, seeded from ratcheted priors kept on disk, and
    a batch whose predicted duration overflows it is re-run at the bucket
    it needs;
  * noise is drawn on the device from a per-dispatch ``torch.Generator``
    seeded from the engine's host-side chain (production) or injected
    (parity path);
  * on the card every synthesis call (the fused batch, a streamed chunk's
    flow and each vocoder window, the injected-noise path's two stages, the
    progress path's text stage, cross K/V, steps and vocoder) replays a
    CUDA graph captured per static shape at first use
    (``programs.Programs``, the counterpart of the JAX engine's jitted
    programs; ``warmup`` captures the lattice); on the CPU the same
    functions of ``synthesis`` run eagerly;
  * ``infer_batch_begin`` queues a batch and its device->host copies;
    ``infer_batch_end`` resolves it. The copies run on a side stream after
    an event recorded behind the batch, so a result never waits behind
    work queued later on the compute stream;
  * over a device mesh (``parallel.mesh``), every batch is split over the
    data rows, one ``Shard`` each: a replica of the params (split over the
    row's model ranks), its programs on a card when the row has one rank,
    and its slice of the batch. The whole batch's noise is drawn once on
    the lead device, so a mesh engine equals the single-device engine with
    the same seed; each shard runs its flow, the rows' frame masks are
    max-reduced across shards (the vocoder masks frames past the whole
    batch's longest row), each shard vocodes, and the outputs are gathered
    in row order on the lead device. The host never waits between shards.
    A row with several model ranks runs eagerly: a CUDA graph cannot span
    devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from ..config import TTSConfig
from ..frontend import UnicodeProcessor
from ..utils.timing import StageProfiler
from . import buckets, programs, synthesis
from .longform import LongFormSynthesis

EGRESS_FORMATS = ("int16", "f32", "mulaw")


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

    def blend(self, other: "VoiceStyle", t: float) -> "VoiceStyle":
        """Linear interpolation in style-embedding space: t=0 -> self, t=1 ->
        other (an intermediate voice)."""
        if self.ttl.shape != other.ttl.shape or self.dp.shape != other.dp.shape:
            raise ValueError(
                f"style shapes differ: {self.ttl.shape}/{self.dp.shape} vs "
                f"{other.ttl.shape}/{other.dp.shape}")
        t = float(t)
        return VoiceStyle(
            ((1.0 - t) * self.ttl + t * other.ttl).astype(np.float32),
            ((1.0 - t) * self.dp + t * other.dp).astype(np.float32),
        )

    def take(self, idx) -> "VoiceStyle":
        return VoiceStyle(self.ttl[idx], self.dp[idx])


def parse_blend_spec(spec: str) -> tuple[str, str, float]:
    """Parse the 'A+B' / 'A+B:t' blended-voice syntax shared by the HTTP
    service and the CLI into (name_a, name_b, t). Raises ValueError on a
    malformed spec or out-of-range weight (t defaults to 0.5)."""
    body, _, t_str = spec.partition(":")
    a, _, b = body.partition("+")
    try:
        t = float(t_str) if t_str else 0.5
    except ValueError:
        raise ValueError(f"invalid blend weight in {spec!r}")
    if not a or not b or "+" in b or not (0.0 <= t <= 1.0):
        raise ValueError(
            f"invalid blend spec {spec!r} (use 'A+B' or 'A+B:t', t in [0, 1])")
    return a, b, t


@dataclasses.dataclass
class PendingBatch:
    """A dispatched fused-synthesis batch (infer_batch_begin): the device
    results, the host copies already queued for them, and what
    infer_batch_end needs to resolve, re-run and record metrics."""

    wav_dev: torch.Tensor
    dur_dev: torch.Tensor
    wav_src: torch.Tensor | None  # pre-sliced egress view, None on device_output
    dev_args: tuple
    text_mask: np.ndarray
    b_true: int
    t_bucket: int
    n_xfer: int
    total_step: int
    speed: float
    device_output: bool
    t_start: float
    n_chars: int
    ready: object = None  # CUDA event recorded behind the batch (None on the CPU)
    fetch: tuple | None = None  # the queued host copies (see _fetch)


@dataclasses.dataclass
class Shard:
    """One data row of an engine: the row's lead device, its replica of
    the params and its captured programs (None where it runs eagerly: on
    the CPU, and for a row of several model ranks). A single-device engine
    has one."""

    device: torch.device
    params: object
    programs: programs.Programs | None

    @property
    def synth(self):
        """The synthesis calls: the programs' replays, or the eager ones."""
        return synthesis if self.programs is None else self.programs

    def on(self):
        """The shard's device as the current one, where it is a card."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())


class SynthesisEngine(LongFormSynthesis):
    def __init__(self, params, cfg: TTSConfig, processor: UnicodeProcessor, *,
                 precision: str | None = None, seed: int = 0,
                 egress_format: str = "int16", device=None, backend=None,
                 fused_ffn: bool = True, fused_resblocks: bool | None = None,
                 mesh=None):
        """``params``: the JAX-layout numpy param tree (loaded here onto
        ``device`` in the compute dtype) or modules from
        ``models.load_params``. ``precision="int8"`` quantizes a numpy tree
        that holds no ``w_q`` yet (``models.quantize_params``); the params
        stay unfused, as in the JAX engine. ``egress_format``: the waveform's
        form on its way to the host, "int16", "mulaw" (8-bit G.711) or
        "f32". ``device`` defaults to ``cuda`` and raises when there is no
        card; pass ``device="cpu"`` for the plain path.

        ``backend``: a stage-function provider in place of the native
        models (``assets.onnx_backend.OnnxStageBackend``: the four ONNX
        graphs composed into the engine's stages, on the backend's device).
        ``params`` is then the backend's tree (``backend.params`` when
        None) and is neither loaded nor quantized; every other part of the
        engine applies unchanged, except windowed streaming, which stays
        native.

        ``fused_ffn``: the vector estimator's AdaLN FFN through the fused
        kernel (the default), or, with False, through ``linear``, silu and
        ``linear`` (the JAX engine's default, whose products are cuBLAS
        calls here). The W8A8 path takes the unfused FFN either way. The
        vocoder's upsample convs run as products when ``TTS_VOC_UP_MATMUL=1``
        at construction (``vocoder.apply(up_matmul=)``); the engine reads the
        variable once, here.

        ``fused_resblocks``: the vocoder's fine-timeline chains through the
        chain kernel (``vocoder.apply(fused_resblocks=)``), or with False
        through ``_resblock``'s convs. None reads ``TTS_VOC_FUSED`` once,
        here: the kernel unless it is "0". The JAX engine runs the kernel
        only at "1"; the port keeps it as its default, as it keeps
        ``fused_ffn``.

        ``mesh``: a ``parallel.mesh.Mesh`` (axes data, model). The params
        are placed with ``shard_params`` (the TP layout over each row's
        model ranks; a graph backend's weights replicated) and every batch
        is split over the data rows (see the module's docstring); the lead
        device ``mesh.devices[0, 0]`` takes the place of ``device``. With
        model > 1 every transformer network's heads and FFN width must
        divide by it. Windowed streaming stays off, as in the JAX engine."""
        import os

        from ..models import load_params, quantize_params, to_numpy_tree
        from ..models.vocoder import fused_resblocks_default

        if egress_format not in EGRESS_FORMATS:
            raise ValueError(f"egress_format must be one of {EGRESS_FORMATS}, "
                             f"got {egress_format!r}")
        self.backend = backend
        if backend is not None:
            device = backend.device if device is None else device
            if params is None:
                params = backend.params
        self.mesh = mesh
        if mesh is not None:
            if device is not None and backend is None:
                raise ValueError("pass either device or mesh, not both")
            device = mesh.devices[0, 0]
        self.device = resolve_device(device)
        self.cfg = cfg
        self.processor = processor
        self.precision = precision or cfg.runtime.precision
        self.dtype = synthesis.dtype_of(self.precision)
        if backend is None and (mesh is not None
                                or not isinstance(params, torch.nn.Module)):
            if isinstance(params, torch.nn.Module):
                params = to_numpy_tree(params)
            if self.precision == "int8" and not _tree_has_key(params, "w_q"):
                params = quantize_params(params)
            if mesh is None:
                params = load_params(params, device=self.device, dtype=self.dtype)
        self.egress_format = egress_format
        self.fused_ffn = bool(fused_ffn)
        self.up_matmul = os.environ.get("TTS_VOC_UP_MATMUL", "0") == "1"
        self.fused_resblocks = (fused_resblocks_default() if fused_resblocks is None
                                else bool(fused_resblocks))
        # the synthesis calls: replays of captured programs on the card, the
        # eager functions on the CPU and on a row of several model ranks
        if mesh is None:
            self._data_size = 1
            self.shards = [Shard(self.device, params,
                                 programs.Programs(self.device)
                                 if self.device.type == "cuda" else None)]
        else:
            from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, check_tensor_parallel,
                                         shard_params)

            model = mesh.shape[MODEL_AXIS]
            if backend is None:
                check_tensor_parallel(cfg, model)
            self._data_size = mesh.shape[DATA_AXIS]
            self.shards = [
                Shard(dev, p, programs.Programs(dev)
                      if dev.type == "cuda" and model == 1 else None)
                for dev, p in zip(mesh.leads, shard_params(params, mesh, dtype=self.dtype))]
        # the lead shard serves the single-row paths (progress, streaming)
        self.params = self.shards[0].params
        self.programs = self.shards[0].programs
        self._synth = self.shards[0].synth
        self.profiler = StageProfiler()
        # the host chain each dispatch's noise generator is seeded from
        self._seed_chain = torch.Generator().manual_seed(seed)
        # guards the engine's host-side mutable state (the seed chain, the
        # learned rate, the style cache, lazy builds): the batcher thread and
        # streaming handler threads drive one engine. Never held across
        # device work, which would serialize their dispatches.
        self._host_mutex = threading.RLock()
        # device->host copies run here, behind an event recorded after the
        # batch they read, never behind later work on the compute stream
        self._egress_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        # learned seconds-per-char per text-length bucket: the window max
        # times a margin picks the latent bucket; an overflow re-runs. Each
        # window is seeded from a prior that ratchets up and is kept on disk,
        # so a fresh process picks the buckets the last one settled on.
        self._spc_windows: dict[int, deque] = {}
        self._spc_priors: dict[int, float] = self._load_rate_cache()
        self._spc_counts: dict[int, int] = {}  # real observations per bucket
        self._spc_default_prior = 1.0 / 11.0
        self._spc_margin = 1.05
        self._rate_frozen = False
        self._style_dev_cache: dict[tuple, tuple] = {}

    @property
    def stats(self) -> dict:
        return {"bucket_overflows": self.profiler.counters.get("bucket_overflows", 0)}

    # ------------------------------------------------------------------
    # learned speaking rate, persisted per text-length bucket
    # ------------------------------------------------------------------

    def _rate_cache_path(self) -> str:
        """``$TTS_RATE_CACHE_DIR`` (default ``~/.cache/supertonic_tpu_torch``)
        / ``stpu_rates_<config key>.json``; never the JAX package's file."""
        import hashlib
        import os

        cfg_key = hashlib.md5(
            f"{self.cfg.chunk_size}:{self.cfg.sample_rate}:"
            f"{self.cfg.duration_predictor.dim}".encode()).hexdigest()[:10]
        base = os.environ.get("TTS_RATE_CACHE_DIR") or os.path.expanduser(
            "~/.cache/supertonic_tpu_torch")
        return os.path.join(base, f"stpu_rates_{cfg_key}.json")

    def _load_rate_cache(self) -> dict[int, float]:
        import json

        try:
            with open(self._rate_cache_path()) as f:
                raw = json.load(f)
            return {int(k): float(v) for k, v in raw.items()
                    if 0.001 < float(v) < 1.0}
        except (OSError, ValueError, AttributeError, TypeError):
            return {}  # missing, corrupted or hand-edited: start from defaults

    def _save_rate_cache(self) -> None:
        import json
        import os

        try:
            path = self._rate_cache_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # write-then-rename: a process starting at the same moment must
            # never read a torn file
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump({str(k): round(v, 6)
                           for k, v in sorted(self._spc_priors.items())}, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def _spc_window_for(self, l_bucket: int) -> deque:
        """This text-length bucket's recent-rate window, created on first use
        seeded with the persisted prior; an unseen bucket inherits the
        largest smaller bucket's prior (rates fall with text length), else
        the conservative default."""
        with self._host_mutex:
            w = self._spc_windows.get(l_bucket)
            if w is None:
                prior = self._spc_priors.get(l_bucket)
                if prior is None:
                    smaller = [b for b in self._spc_priors if b <= l_bucket]
                    prior = (self._spc_priors[max(smaller)] if smaller
                             else self._spc_default_prior)
                w = self._spc_windows[l_bucket] = deque([prior], maxlen=16)
            return w

    def _spc_estimate(self, l_bucket: int) -> float:
        return max(self._spc_window_for(l_bucket))

    def _observe_rate(self, l_bucket: int, obs_spc: float) -> None:
        """Feed one observed seconds-per-char into the learned rate: window
        append, count, the prior's ratchet up (on a 1e-6 ceiling grid that
        the cache file round-trips exactly) and its write-down once a full
        window of real observations sits well below it."""
        if self._rate_frozen:
            return
        import math

        with self._host_mutex:
            win = self._spc_window_for(l_bucket)
            win.append(obs_spc)
            self._spc_counts[l_bucket] = self._spc_counts.get(l_bucket, 0) + 1
            q = math.ceil(obs_spc * 1e6) / 1e6
            prior = self._spc_priors.get(l_bucket, 0.0)
            if q > prior:
                self._spc_priors[l_bucket] = q
                self._save_rate_cache()
            elif (self._spc_counts[l_bucket] >= win.maxlen and prior > 0.0
                  and max(win) < prior * 0.9):
                self._spc_priors[l_bucket] = math.ceil(max(win) * 1e6) / 1e6
                self._save_rate_cache()

    def _pin_rate(self, rate: float = 1.0 / 11.0) -> None:
        """Test hook: force a uniform learned rate for every bucket."""
        self._spc_windows = {}
        self._spc_priors = {}
        self._spc_counts = {}
        self._spc_default_prior = rate

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def _speed(self, speed: float, device=None) -> torch.Tensor:
        """``speed`` as a 0-dim f32 tensor on the device (a shard's, when
        given), as the JAX engine passes an array: the duration is then a
        true division on the card, never a product with the reciprocal."""
        return torch.full((), float(speed), dtype=torch.float32,
                          device=self.device if device is None else device)

    def _next_generator(self) -> torch.Generator:
        """A noise generator of its own for one dispatch, seeded from the
        engine's chain: concurrent dispatches never share noise."""
        with self._host_mutex:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._seed_chain))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _pad_batch(self, arrs: list[np.ndarray], b_bucket: int) -> list[np.ndarray]:
        """Pad the batch dim by repeating row 0 (sliced off after compute)."""
        out = []
        for a in arrs:
            b = a.shape[0]
            if b < b_bucket:
                a = np.concatenate([a, np.repeat(a[:1], b_bucket - b, axis=0)], 0)
            out.append(a)
        return out

    def _device_style(self, style: VoiceStyle, b_bucket: int, *, sharded: bool = True):
        """Batch-padded (style_dp, style_ttl) on the device, cached by
        content fingerprint and bucket (LRU, 32 entries); on a mesh, unless
        ``sharded`` is False, the lists of each shard's rows."""
        sharded = sharded and self.mesh is not None
        key = (style.fingerprint(), b_bucket, sharded)
        with self._host_mutex:
            hit = self._style_dev_cache.pop(key, None)
            if hit is not None:
                self._style_dev_cache[key] = hit  # newest last
                return hit
        ttl, dp = self._pad_batch([style.ttl, style.dp], b_bucket)
        dp, ttl = np.asarray(dp, np.float32), np.asarray(ttl, np.float32)
        if sharded:
            from ..parallel.mesh import shard_batch

            hit = shard_batch(self.mesh, dp, ttl)
        else:
            hit = (torch.as_tensor(dp).to(self.device), torch.as_tensor(ttl).to(self.device))
        with self._host_mutex:
            while len(self._style_dev_cache) >= 32:
                self._style_dev_cache.pop(next(iter(self._style_dev_cache)))
            self._style_dev_cache[key] = hit
        return hit

    def _prepare_inputs(self, text_list, lang_list, style,
                        pre_normalized: bool = False):
        """Frontend + bucketing + device placement. Returns (dev_args,
        text_mask, l_true, b_true, b_bucket); on a mesh each of the four
        device arguments is the list of the shards' rows."""
        rt = self.cfg.runtime
        b_true = len(text_list)
        with self.profiler.stage("frontend"):
            text_ids, text_mask3 = self.processor(text_list, lang_list,
                                                  pre_normalized=pre_normalized)
            l_true = text_ids.shape[1]
            pad_l = buckets.pick_bucket(l_true, rt.text_buckets) - l_true
            text_ids = np.pad(text_ids, ((0, 0), (0, pad_l)))
            text_mask = np.pad(text_mask3[:, 0, :], ((0, 0), (0, pad_l)))
        b_bucket = buckets.pick_bucket(b_true, rt.batch_buckets)
        if b_bucket % self._data_size:
            b_bucket = -(-b_bucket // self._data_size) * self._data_size
        text_ids, text_mask = self._pad_batch([text_ids, text_mask], b_bucket)
        if self.mesh is None:
            ids_dev = torch.as_tensor(text_ids, dtype=torch.int64).to(self.device)
            mask_dev = torch.as_tensor(text_mask, dtype=torch.float32).to(self.device)
        else:
            from ..parallel.mesh import shard_batch

            ids_dev, mask_dev = shard_batch(self.mesh, text_ids.astype(np.int64),
                                            text_mask.astype(np.float32))
        sdp_dev, sttl_dev = self._device_style(style, b_bucket)
        return (ids_dev, mask_dev, sdp_dev, sttl_dev), text_mask, l_true, b_true, b_bucket

    # ------------------------------------------------------------------
    # device -> host
    # ------------------------------------------------------------------

    def _mark(self):
        """An event recorded on this thread's current stream (None on the
        CPU): what a later copy of the results queued so far waits on."""
        if self._egress_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _fetch(self, tensors, ready) -> tuple:
        """Queue device->host copies of ``tensors`` into pinned memory on the
        egress stream, after ``ready``. Returns (host tensors, done event);
        on the CPU the tensors themselves and no event."""
        if self._egress_stream is None:
            return list(tensors), None
        stream = self._egress_stream
        hosts = []
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for t in tensors:
                # a pinned buffer (PyTorch caches them) copies several times
                # faster than pageable memory would
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)  # the allocator keeps t until the copy ran
                hosts.append(h)
            done = torch.cuda.Event()
            done.record(stream)
        return hosts, done

    @staticmethod
    def _wait(fetch) -> list[torch.Tensor]:
        hosts, done = fetch
        if done is not None:
            done.synchronize()
        return hosts

    def _decode_egress(self, wav: torch.Tensor) -> np.ndarray:
        """A host copy of the egress waveform -> f32 numpy."""
        if wav.dtype == torch.int16:
            # decoded with torch's threaded kernels: at b64 this is several
            # times faster than numpy's astype and divide
            return wav.float().div_(32767.0).numpy()
        if wav.dtype == torch.uint8:
            from ..utils.mulaw import decode

            return decode(wav.numpy())
        return wav.float().numpy()

    def to_host(self, wav_dev: torch.Tensor, ready=None) -> np.ndarray:
        """Transfer a device waveform (a device_output=True result) to a host
        f32 array, undoing the egress quantization (int16 or mu-law).
        ``ready``: the event the copy waits on (``PendingBatch.ready`` of the
        batch that made it); by default one recorded now on this thread's
        stream."""
        with torch.inference_mode():
            if ready is None:
                ready = self._mark()
            (host,) = self._wait(self._fetch([wav_dev], ready))
        return self._decode_egress(host)

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    def infer_batch(self, text_list, lang_list, style: VoiceStyle,
                    total_step: int = 5, speed: float = 1.05,
                    noise: np.ndarray | None = None, device_output: bool = False):
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
            text_list, lang_list, style, total_step, speed,
            device_output=device_output))

    def _fused(self, dev_args, total_step: int, t_bucket: int, speed: float):
        with self.profiler.stage("fused_synthesis"):
            if self.mesh is not None:
                return self._mesh_fused(dev_args, total_step, t_bucket, speed)
            if self.backend is not None and self.programs is None:
                return self.backend.fused_fn(
                    self.params, *dev_args, self._next_generator(),
                    self._speed(speed), int(total_step), int(t_bucket),
                    self.egress_format)
            extra = {} if self.backend is None else {"backend": self.backend}
            return self._synth.synthesize_fused(
                self.params, self.cfg, *dev_args, self._next_generator(),
                self._speed(speed), int(total_step), int(t_bucket),
                precision=self.precision, egress=self.egress_format,
                fused_ffn=self.fused_ffn, up_matmul=self.up_matmul,
                fused_resblocks=self.fused_resblocks, **extra)

    def _mesh_fused(self, dev_args, total_step: int, t_bucket: int, speed: float):
        """The fused call over the mesh: the whole batch's noise drawn once
        on the lead device from the dispatch generator (the single-device
        engine's numbers), each shard's flow on its rows of it, the frame
        masks max-reduced across shards, each shard's vocoding with the
        result, and the outputs gathered in row order on the lead."""
        ids, mask, sdp, sttl = dev_args
        noise = synthesis._noise(self.cfg, sum(t.shape[0] for t in ids), t_bucket,
                                 self._next_generator(), self.device)
        flows = []
        for s, i, m, sd, st, nz in zip(self.shards, ids, mask, sdp, sttl,
                                       noise.chunk(len(self.shards))):
            with s.on():
                flows.append(self._shard_flow(s, i, m, sd, st, nz.to(s.device),
                                              speed, total_step))
        fmask = torch.stack([f[2].to(self.device) for f in flows]).amax(0)
        wavs = []
        for s, (x, _dur, _fm) in zip(self.shards, flows):
            with s.on():
                wavs.append(self._shard_vocode(s, x, fmask.to(s.device)))
        return (torch.cat([w.to(self.device) for w in wavs]),
                torch.cat([f[1].to(self.device) for f in flows]))

    def _shard_flow(self, s: Shard, ids, mask, sdp, sttl, noise, speed, total_step: int):
        """One shard's text stage and flow loop on its noise: (latent,
        duration, the shard's frame mask)."""
        spd = self._speed(speed, s.device)
        if self.backend is not None and s.programs is None:
            return self.backend.flow_fn(s.params, ids, mask, sdp, sttl, noise, spd,
                                        int(total_step))
        extra = {} if self.backend is None else {"backend": self.backend}
        return s.synth.flow_padded(s.params, self.cfg, ids, mask, sdp, sttl, noise, spd,
                                   int(total_step), precision=self.precision,
                                   fused_ffn=self.fused_ffn, **extra)

    def _shard_vocode(self, s: Shard, x, fmask):
        """One shard's vocoding of its whole latent with the batch's frame
        mask, in the egress form."""
        if self.backend is not None and s.programs is None:
            return synthesis.encode_egress(self.backend.vocode_fn(s.params, x, fmask),
                                           self.egress_format)
        extra = {} if self.backend is None else {"backend": self.backend}
        return s.synth.vocode_window(s.params, self.cfg, x, fmask, 0, x.shape[1], 0,
                                     precision=self.precision, egress=self.egress_format,
                                     up_matmul=self.up_matmul,
                                     fused_resblocks=self.fused_resblocks, **extra)

    def _programs_of(self, shard: Shard | None):
        """(programs, params) of ``shard``; the engine's own (the lead
        shard's) for None."""
        if shard is None:
            return self.programs, self.params
        return shard.programs, shard.params

    def _text_stage(self, ids, mask, sdp, sttl, speed, shard: Shard | None = None):
        progs, params = self._programs_of(shard)
        if progs is not None:
            return progs.text_stage(params, self.cfg, ids, mask, sdp, sttl, speed,
                                    precision=self.precision, backend=self.backend)
        if self.backend is not None:
            return self.backend.text_fn(params, ids, mask, sdp, sttl, speed)
        return synthesis.text_stage(params, self.cfg, ids, mask, sdp, sttl,
                                    speed, precision=self.precision)

    def _acoustic_stage(self, emb, sttl, tmask, lmask, noise, total_step: int,
                        shard: Shard | None = None, frame_mask=None):
        progs, params = self._programs_of(shard)
        if progs is not None:
            return progs.acoustic_stage(
                params, self.cfg, emb, sttl, tmask, lmask, noise, total_step,
                precision=self.precision, fused_ffn=self.fused_ffn,
                up_matmul=self.up_matmul, fused_resblocks=self.fused_resblocks,
                backend=self.backend, frame_mask=frame_mask)
        if self.backend is not None:
            return self.backend.acoustic_fn(params, emb, sttl, tmask, lmask,
                                            noise, total_step, frame_mask=frame_mask)
        return synthesis.acoustic_stage(params, self.cfg, emb, sttl, tmask,
                                        lmask, noise, total_step,
                                        precision=self.precision,
                                        fused_ffn=self.fused_ffn,
                                        up_matmul=self.up_matmul,
                                        fused_resblocks=self.fused_resblocks,
                                        frame_mask=frame_mask)

    def infer_batch_begin(self, text_list, lang_list, style: VoiceStyle,
                          total_step: int = 5, speed: float = 1.05, *,
                          device_output: bool = False,
                          pre_normalized: bool = False) -> PendingBatch:
        """Queue a fused-synthesis batch at the latent bucket the learned
        rate predicts, and its host copies (the duration, and on the host
        path the waveform slice the estimate says exists) on the egress
        stream behind it. Resolve with infer_batch_end. ``device_output``:
        the waveform stays on the device (``to_host`` fetches it);
        ``pre_normalized``: the texts already went through
        ``preprocess_text``."""
        _check_batch(text_list, style)
        if not text_list:
            raise ValueError("infer_batch_begin requires a non-empty batch")
        if not speed > 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        t_start = time.perf_counter()
        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        with torch.inference_mode():
            dev_args, text_mask, l_true, b_true, _bb = self._prepare_inputs(
                text_list, lang_list, style, pre_normalized=pre_normalized)
            est_secs = (l_true * self._spc_estimate(text_mask.shape[1])
                        * self._spc_margin / min(speed, 1.0))
            t_bucket = buckets.pick_bucket(
                buckets.latent_len_for_duration(est_secs, sr, chunk),
                rt.latent_buckets)
            # the transferred slice uses a leaner margin than the bucket
            # choice: an undershoot costs only the rare tail fetch
            t_slice = buckets.latent_len_for_duration(
                est_secs * (1.04 / self._spc_margin), sr, chunk)
            n_xfer = min(t_bucket, buckets.quantize_up(max(t_slice, 1), 8))
            wav_dev, dur_dev = self._fused(dev_args, total_step, t_bucket, speed)
            pending = PendingBatch(
                wav_dev=wav_dev, dur_dev=dur_dev, wav_src=None, dev_args=dev_args,
                text_mask=text_mask, b_true=b_true, t_bucket=t_bucket,
                n_xfer=n_xfer, total_step=total_step, speed=speed,
                device_output=device_output, t_start=t_start,
                n_chars=sum(len(t) for t in text_list))
            self._queue_copies(pending)
        return pending

    def _queue_copies(self, p: PendingBatch) -> None:
        """Record the batch's event and queue its host copies: the data
        streams back the moment compute finishes, not when end() asks."""
        chunk = self.cfg.chunk_size
        p.ready = self._mark()
        p.wav_src = None if p.device_output else p.wav_dev[:p.b_true, :p.n_xfer * chunk]
        p.fetch = self._fetch([p.dur_dev] + ([] if p.wav_src is None else [p.wav_src]),
                              p.ready)

    def infer_batch_end(self, pending: PendingBatch):
        """Resolve a dispatch: wait for the duration (and the waveform on the
        host path), re-run at a larger bucket on overflow, fetch a missing
        tail, update the learned rate, record metrics."""
        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        p = pending
        b_true = p.b_true
        with torch.inference_mode():
            for attempt in range(4):
                with self.profiler.stage("duration_sync" if p.device_output else "egress"):
                    hosts = self._wait(p.fetch)
                dur = hosts[0].numpy()
                t_needed = int(((dur[:b_true] * sr).astype(np.int64).max()
                                + chunk - 1) // chunk)
                if t_needed <= p.t_bucket:
                    if not p.device_output:
                        wav_host = hosts[1]
                        if t_needed > p.n_xfer:
                            # the sliced copy undershot the true duration:
                            # fetch the missing tail (rare)
                            self.profiler.bump("egress_tail_fetches")
                            tail = p.wav_dev[:b_true, p.n_xfer * chunk:t_needed * chunk]
                            with self.profiler.stage("egress"):
                                (tail_host,) = self._wait(self._fetch([tail], p.ready))
                            wav_host = torch.cat([wav_host, tail_host], dim=1)
                    break
                self.profiler.bump("bucket_overflows")
                from ..utils.logging import default_logger as log

                log.warning("latent_bucket_overflow", needed=t_needed,
                            bucket=p.t_bucket, attempt=attempt + 1)
                p.t_bucket = buckets.pick_bucket(t_needed, rt.latent_buckets)
                p.n_xfer = min(p.t_bucket, buckets.quantize_up(t_needed, 8))
                p.wav_dev, p.dur_dev = self._fused(p.dev_args, p.total_step,
                                                   p.t_bucket, p.speed)
                self._queue_copies(p)
            else:
                # duration is deterministic per input, so one re-run always fits
                self.profiler.bump("bucket_overflow_exhausted")
                raise RuntimeError(
                    f"latent bucket overflow persisted after retries (needed "
                    f"{t_needed} > bucket {p.t_bucket}); refusing to return "
                    f"truncated audio")
        # once per request, outside the re-run loop: duration is
        # deterministic, so a re-run would count the same observation twice
        row_chars = np.maximum(p.text_mask[:b_true].sum(axis=1), 1.0)
        self._observe_rate(p.text_mask.shape[1],
                           float((dur[:b_true] * p.speed / row_chars).max()))
        audio_s = float(np.sum(dur[:b_true]))
        if p.device_output:
            # per-request latency is recorded by the caller when the audio
            # reaches the host (the batcher's egress pool)
            self.profiler.record_throughput(audio_s, p.n_chars,
                                            time.perf_counter() - p.t_start)
            return p.wav_dev[:b_true], dur[:b_true]
        wav_np = self._decode_egress(wav_host)
        self.profiler.record_result(audio_s, p.n_chars,
                                    time.perf_counter() - p.t_start)
        return wav_np, dur[:b_true]

    def _infer_injected_noise(self, dev_args, noise, b_true, b_bucket,
                              total_step, speed):
        """Parity path: text stage, a duration sync to size the latent grid
        to the caller's noise, then the acoustic stage (on the card, the
        ``text`` and ``acoustic`` programs). On a mesh each shard runs both
        on its rows, and the acoustic stage takes the whole batch's frame
        mask."""
        if self.mesh is not None:
            return self._mesh_injected_noise(dev_args, noise, b_true, b_bucket,
                                             total_step, speed)
        ids, mask, sdp, sttl = dev_args
        with torch.inference_mode():
            with self.profiler.stage("text_stage"):
                dur_dev, emb = self._text_stage(ids, mask, sdp, sttl, self._speed(speed))
                dur = dur_dev.cpu().numpy()
            latent_mask, noise_arr = self._latent_grid(dur, noise, b_true, b_bucket)
            with self.profiler.stage("acoustic_stage"):
                wav = self._acoustic_stage(
                    emb, sttl, mask, torch.as_tensor(latent_mask).to(self.device),
                    torch.as_tensor(noise_arr).to(self.device), int(total_step))
            with self.profiler.stage("egress"):
                wav_np = wav[:b_true].cpu().numpy()
        return wav_np, dur[:b_true]

    def _latent_grid(self, dur: np.ndarray, noise: np.ndarray, b_true: int,
                     b_bucket: int):
        """The injected-noise path's latent mask [B, T] and noise [B, T, C]
        at the latent bucket the predicted duration needs."""
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        latent_lengths = ((dur * sr).astype(np.int64) + chunk - 1) // chunk
        t_bucket = buckets.pick_bucket(int(latent_lengths[:b_true].max()),
                                       self.cfg.runtime.latent_buckets)
        latent_mask = (np.arange(t_bucket)[None, :]
                       < latent_lengths[:, None]).astype(np.float32)
        noise_arr = np.zeros((b_bucket, t_bucket, self.cfg.latent_channels), np.float32)
        t_copy = min(noise.shape[1], t_bucket)
        noise_arr[: noise.shape[0], :t_copy] = noise[:, :t_copy]
        return latent_mask, noise_arr

    def _mesh_injected_noise(self, dev_args, noise, b_true, b_bucket, total_step, speed):
        from ..parallel.mesh import shard_batch

        ids, mask, sdp, sttl = dev_args
        with torch.inference_mode():
            with self.profiler.stage("text_stage"):
                stages = []
                for s, i, m, sd, st in zip(self.shards, ids, mask, sdp, sttl):
                    with s.on():
                        stages.append(self._text_stage(i, m, sd, st,
                                                       self._speed(speed, s.device), shard=s))
                dur = torch.cat([d.cpu() for d, _emb in stages]).numpy()
            latent_mask, noise_arr = self._latent_grid(dur, noise, b_true, b_bucket)
            fmask = latent_mask.max(0)
            lmasks, noises = shard_batch(self.mesh, latent_mask, noise_arr)
            with self.profiler.stage("acoustic_stage"):
                wavs = []
                for s, (_d, emb), st, m, lm, nz in zip(self.shards, stages, sttl, mask,
                                                       lmasks, noises):
                    with s.on():
                        wavs.append(self._acoustic_stage(
                            emb, st, m, lm, nz, int(total_step), shard=s,
                            frame_mask=torch.as_tensor(fmask).to(s.device)))
            with self.profiler.stage("egress"):
                wav_np = torch.cat([w.cpu() for w in wavs])[:b_true].numpy()
        return wav_np, dur[:b_true]

    def warmup(self, *, batch_sizes: tuple[int, ...] | None = None,
               text_buckets: tuple[int, ...] | None = None,
               total_steps: tuple[int, ...] = (2, 5), progress=None) -> int:
        """Run synthetic batches over the common bucket lattice before live
        traffic: on the card the first of them builds the kernels, and each
        captures the fused program of its shape (at the latent bucket its
        text gets), as the JAX engine compiles its programs here. Returns the
        number of batches run. They stay out of the profiler and of the
        learned rate (synthetic rows are not speech)."""
        rt = self.cfg.runtime
        # `is None`, not falsy: an empty tuple warms nothing for that dim
        bss = (tuple(b for b in rt.batch_buckets if b <= 32)
               if batch_sizes is None else batch_sizes)
        lbs = rt.text_buckets[:3] if text_buckets is None else text_buckets
        rng = np.random.default_rng(0)
        live_profiler, live_windows = self.profiler, self._spc_windows
        self.profiler = StageProfiler()
        self._spc_windows = {}
        self._rate_frozen = True
        try:
            return self._warmup_lattice(bss, lbs, total_steps, progress, rng)
        finally:
            self.profiler = live_profiler
            self._spc_windows = live_windows
            self._rate_frozen = False

    def _warmup_lattice(self, bss, lbs, total_steps, progress, rng) -> int:
        n = 0
        for b in bss:
            style = VoiceStyle(
                rng.standard_normal((1, self.cfg.ttl.style.n_style,
                                     self.cfg.ttl.style.style_value_dim)).astype(np.float32),
                rng.standard_normal((1, self.cfg.dp.style.n_style,
                                     self.cfg.dp.style.style_value_dim)).astype(np.float32),
            ).tile(b)
            for lb in lbs:
                # a text that lands exactly in bucket lb (tags cost 9 chars)
                text = "a" * max(1, lb - 12) + "."
                for steps in total_steps:
                    self.infer_batch([text] * b, ["en"] * b, style,
                                     total_step=steps, device_output=True)
                    n += 1
                    if progress:
                        progress(n, len(bss) * len(lbs) * len(total_steps))
        return n

    # ------------------------------------------------------------------
    # step-at-a-time and windowed paths (__call__ / batch / stream / trim
    # come from LongFormSynthesis)
    # ------------------------------------------------------------------

    def infer_with_progress(self, text: str, lang: str, style: VoiceStyle,
                            total_step: int = 5, speed: float = 1.05,
                            progress_callback=None):
        """Single-utterance synthesis with a per-denoising-step callback:
        the Euler loop runs one estimator step at a time (the cross K/V
        computed once) and ``progress_callback(step, total_step)`` fires
        once the step has finished on the device. On the card the text
        stage, the cross K/V, each step and the vocoder replay their
        programs (``text``, ``cross``, ``step``, ``vocoder``), as the JAX
        engine calls its jitted ``_text_fn``, ``_cross_fn``, ``_step_fn``
        and ``_vocoder_fn``. Slower than the fused path; for interactive
        front ends, not serving."""
        if style.batch != 1:
            raise ValueError("infer_with_progress takes a single style")
        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        ids, mask3 = self.processor([text], [lang])
        l_bucket = buckets.pick_bucket(ids.shape[1], rt.text_buckets)
        ids = np.pad(ids, ((0, 0), (0, l_bucket - ids.shape[1])))
        mask = np.pad(mask3[:, 0, :], ((0, 0), (0, l_bucket - mask3.shape[2])))
        with torch.inference_mode():
            # one row: the lead shard's alone on a mesh
            sdp, sttl = self._device_style(style, 1, sharded=False)
            tmask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
            dur_dev, emb = self._text_stage(
                torch.as_tensor(ids, dtype=torch.int64).to(self.device), tmask,
                sdp, sttl, self._speed(speed))
            dur = dur_dev.cpu().numpy()
            t_lat = buckets.latent_len_for_duration(float(dur[0]), sr, chunk)
            t_bucket = buckets.pick_bucket(t_lat, rt.latent_buckets)
            lmask = torch.as_tensor(
                (np.arange(t_bucket)[None, :] < t_lat).astype(np.float32)).to(self.device)
            xt = torch.randn((1, t_bucket, self.cfg.latent_channels),
                             generator=self._next_generator(), dtype=torch.float32,
                             device=self.device) * lmask[:, :, None]
            tot = torch.full((1,), float(total_step), dtype=torch.float32,
                             device=self.device)
            step_fn, voc_fn = self._progress_fns(emb, sttl, tmask, lmask, tot)
            for step in range(total_step):
                cur = torch.full((1,), float(step), dtype=torch.float32,
                                 device=self.device)
                xt = step_fn(xt, cur)
                if progress_callback is not None:
                    # progress means completed steps: wait for the device
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                    progress_callback(step + 1, total_step)
            # the batch-max frame mask, as the fused path uses
            wav = voc_fn(xt, lmask.amax(0))
            return wav.cpu().numpy(), dur

    def _progress_fns(self, emb, sttl, tmask, lmask, tot):
        """(step(x, cur), vocoder(x, frame_mask)) of the progress path, with
        the cross K/V computed once: the programs on the card, the eager
        functions on the CPU (a graph backend's ``progress_fns`` there)."""
        if self.backend is not None and self.programs is None:
            # an opaque graph has no cross cache
            _cross, step_fn, voc_fn = self.backend.progress_fns()
            return (lambda x, cur: step_fn(self.params, x, emb, sttl, tmask, lmask, cur, tot),
                    lambda x, fm: voc_fn(self.params, x, fm))
        extra = {} if self.backend is None else {"backend": self.backend}
        synth, prec = self._synth, self.precision
        cache = synth.cross_cache(self.params, self.cfg, emb, sttl, tmask, lmask,
                                  precision=prec, **extra)

        def step(x, cur):
            return synth.euler_step(self.params, self.cfg, x, emb, sttl, tmask, lmask, cur,
                                    tot, cache, precision=prec, fused_ffn=self.fused_ffn,
                                    **extra)

        def voc(x, fm):
            return synth.vocode(self.params, self.cfg, x, fm, precision=prec,
                                up_matmul=self.up_matmul,
                                fused_resblocks=self.fused_resblocks, **extra)

        return step, voc

    def _vocode_stream(self, text: str, lang: str, style, total_step: int,
                       speed: float, window_frames: int):
        """Sub-chunk streaming core. Before the first yield the host waits
        once: one fused text+flow call (the latent, padded with the halo,
        stays on the device; the bucket from the learned rate), window 0
        vocoded, and window 0 and the duration fetched together. Then the
        remaining windows are queued and fetched in doubling groups. On the
        card the flow and every window are replays of captured programs.
        Yields (wav [n] f32, seconds, chunk_end); see
        LongFormSynthesis.stream_windows."""
        from ..models.vocoder import receptive_field_frames

        rt = self.cfg.runtime
        chunk, sr = self.cfg.chunk_size, self.cfg.sample_rate
        halo = receptive_field_frames(self.cfg)
        t0 = time.perf_counter()
        with torch.inference_mode():
            dev_args, text_mask, l_true, _b, _bb = self._prepare_inputs(
                [text], [lang], style)
        l_bucket = text_mask.shape[1]
        est = (l_true * self._spc_estimate(l_bucket) * self._spc_margin
               / min(speed, 1.0))
        t_bucket = buckets.pick_bucket(
            buckets.latent_len_for_duration(est, sr, chunk), rt.latent_buckets)

        def win(k0):
            """Vocode the window emitting frames from k0 (clamped into the
            bucket); returns (k0, start, device wav, its event)."""
            start = max(0, min(k0, t_bucket - w))
            with torch.inference_mode():
                wav = self._synth.vocode_window(
                    self.params, self.cfg, xt_pad, mask_pad, start, w, halo,
                    precision=self.precision, egress=self.egress_format,
                    up_matmul=self.up_matmul, fused_resblocks=self.fused_resblocks)
                return k0, start, wav, self._mark()

        for _attempt in range(4):
            with self.profiler.stage("fused_synthesis"), torch.inference_mode():
                xt_pad, dur_dev, mask_pad = self._synth.flow_fused(
                    self.params, self.cfg, *dev_args, self._next_generator(),
                    self._speed(speed), int(total_step), int(t_bucket),
                    precision=self.precision, halo=halo, fused_ffn=self.fused_ffn)
            w = min(int(window_frames), t_bucket)
            first = win(0)
            with self.profiler.stage("egress"), torch.inference_mode():
                dur_host, w0_host = self._wait(self._fetch([dur_dev, first[2]],
                                                           first[3]))
            dur = dur_host.numpy()
            wav_len = int(float(dur[0]) * sr)
            t_true = max(1, (wav_len + chunk - 1) // chunk)
            if t_true <= t_bucket:
                break
            self.profiler.bump("bucket_overflows")
            t_bucket = buckets.pick_bucket(t_true, rt.latent_buckets)
        else:
            raise RuntimeError("latent bucket overflow persisted in windowed "
                               "streaming")
        # a stream-only server must also learn away its overflow re-runs
        n_chars = max(float(text_mask[0].sum()), 1.0)
        self._observe_rate(l_bucket, float(dur[0]) * speed / n_chars)
        emitted = 0

        def emit(k0, start, host):
            nonlocal emitted
            off = (k0 - start) * chunk
            n_valid = min(wav_len - emitted, w * chunk - off)
            piece = self._decode_egress(host[:1])[0, off: off + n_valid]
            emitted += n_valid
            if emitted >= wav_len:
                self.profiler.record_result(float(dur[0]), len(text),
                                            time.perf_counter() - t0)
            return piece, n_valid / sr, emitted >= wav_len

        yield emit(first[0], first[1], w0_host)
        rest = [win(k0) for k0 in range(w, t_true, w)]
        # doubling groups: few host waits, a steady flow to the client; each
        # group's copies wait only on its own last window
        i, group = 0, 1
        while i < len(rest):
            batch = rest[i: i + group]
            i += len(batch)
            group *= 2
            with self.profiler.stage("egress"), torch.inference_mode():
                fetched = self._wait(self._fetch([h for _k, _s, h, _e in batch],
                                                 batch[-1][3]))
            for (k0, start, _h, _e), host in zip(batch, fetched):
                yield emit(k0, start, host)
