"""Compiled synthesis programs on the card: one CUDA graph per static shape.

The counterpart of the JAX package's jitted programs, which XLA compiles at
the first call of a shape (and over the bucket lattice in ``warmup``):

  program   JAX counterpart           key (its static arguments)
  fused     ``jit_synthesize_fused``  batch and text buckets, latent bucket
                                      ``t_pad``, ``total_step``, precision,
                                      egress
  flow      ``jit_flow_fused``        batch and text buckets, ``t_pad``,
                                      ``total_step``, precision, the halo
                                      frames padded onto the latent
  window    ``jit_vocode_window``     batch, ``window``, ``halo``, precision,
                                      egress
  text      ``jit_text_stage``        batch and text buckets, precision
  acoustic  ``jit_acoustic_stage``    batch, text and latent buckets,
                                      ``total_step``, precision
  cross     the engine's ``_cross_fn``    batch and text buckets, precision,
                                          and the latent bucket (the port's
                                          program also computes the latent's
                                          LARoPE angles)
  step      the engine's ``_step_fn``     batch, text and latent buckets,
                                          precision
  vocoder   the engine's ``_vocoder_fn``  batch, latent bucket, precision

Every key that runs the vector estimator also holds the engine's
``fused_ffn``, and every key that runs the vocoder its ``up_matmul`` and,
when it is off, ``fused_resblocks`` (a trailing "unfused_resblocks"): JAX
fixes them when the engine builds its jitted functions, so two engines with
different settings never share a program.

``Programs`` has the functions of ``synthesis`` that the engine calls, with
their signatures: the fused batch, a streamed chunk's flow and each vocoder
window (a mesh shard's batch is its flow on noise copied in, then one
window over the whole latent with the whole batch's frame mask); the two stages of the injected-noise path (the host syncs on the
duration between them); and the progress path's three calls, whose
``step`` program is replayed once per Euler step with the step number
copied in. The first call of a key runs the function's body
eagerly once at that shape on a side stream (that builds the kernels with
``nvcc``, sets their one-time attributes and brings up cuBLAS and cuDNN),
then captures it into a CUDA graph, under a lock, so that one key is
captured once whichever threads meet it. Every call copies its inputs into
the graph's static buffers, draws its noise into the static noise buffer
from its own generator (the op ``synthesis._noise`` uses, so a seed gives
the same noise as the eager function), replays the graph and clones the
outputs into fresh tensors: the next replay of the key overwrites its static
outputs while an earlier result may still be on its way to the host. The
window's ``start``, a runtime scalar in JAX, becomes the copy of the
window's frames into the static input, so one graph serves every window.

All graphs of one ``Programs`` share a memory pool: a capture reuses what
earlier captures freed, so memory grows with the largest shape plus each
key's static inputs and outputs. The pool is safe to share because each
call's copy-in, replay and clone run as one unit under a lock, ordered on
the device behind the unit before, and no unit waits on the device.

Each program keeps the kernel launches and shapes its capture recorded
(``ops._count``); every replay credits them, so ``ops.launch_counts`` and
``ops.record_launches`` count what the graph ran. A capture or replay that
fails raises: nothing here falls back to eager execution.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import torch

from ..ops import _count
from . import synthesis

# the static arguments of the JAX programs each key holds, beside the
# shapes of the array arguments and the precision (a partial in JAX)
FUSED_STATIC = ("total_step", "t_pad", "egress")
FLOW_STATIC = ("total_step", "t_pad")
WINDOW_STATIC = ("window", "halo", "egress")
TEXT_STATIC = ()
ACOUSTIC_STATIC = ("total_step",)
# the engine's progress closures are plain jax.jit: shapes only
CROSS_STATIC = STEP_STATIC = VOCODER_STATIC = ()


def _resblocks(key: tuple, fused_resblocks: bool) -> tuple:
    """A vocoding key, marked when its chains skip the chain kernel."""
    return key if fused_resblocks else key + ("unfused_resblocks",)


def fused_key(text_ids, total_step: int, t_pad: int, precision: str, egress: str,
              fused_ffn: bool = True, up_matmul: bool = False,
              fused_resblocks: bool = True) -> tuple:
    b, l_pad = text_ids.shape
    return _resblocks(("fused", b, l_pad, int(total_step), int(t_pad), precision, egress,
                       bool(fused_ffn), bool(up_matmul)), fused_resblocks)


def flow_key(text_ids, total_step: int, t_pad: int, precision: str, halo: int,
             fused_ffn: bool = True) -> tuple:
    b, l_pad = text_ids.shape
    return ("flow", b, l_pad, int(total_step), int(t_pad), precision, int(halo),
            bool(fused_ffn))


def window_key(xt_pad, window: int, halo: int, precision: str, egress: str,
               up_matmul: bool = False, fused_resblocks: bool = True) -> tuple:
    return _resblocks(("window", xt_pad.shape[0], int(window), int(halo), precision,
                       egress, bool(up_matmul)), fused_resblocks)


def text_key(text_ids, precision: str) -> tuple:
    b, l_pad = text_ids.shape
    return ("text", b, l_pad, precision)


def acoustic_key(text_emb, latent_mask, total_step: int, precision: str,
                 fused_ffn: bool = True, up_matmul: bool = False,
                 frame_mask: bool = False, fused_resblocks: bool = True) -> tuple:
    b, l_pad = text_emb.shape[:2]
    key = ("acoustic", b, l_pad, latent_mask.shape[1], int(total_step), precision,
           bool(fused_ffn), bool(up_matmul))
    # a mesh shard's program takes the whole batch's frame mask as an input
    return _resblocks(key + ("frame_mask",) if frame_mask else key, fused_resblocks)


def cross_key(text_emb, precision: str, latent_mask) -> tuple:
    """The JAX ``_cross_fn``'s shapes and precision, and the latent length:
    the port's program also computes the latent's LARoPE angles."""
    b, l_pad = text_emb.shape[:2]
    return ("cross", b, l_pad, precision, latent_mask.shape[1])


def step_key(x, text_emb, precision: str, fused_ffn: bool = True) -> tuple:
    return ("step", x.shape[0], text_emb.shape[1], x.shape[1], precision,
            bool(fused_ffn))


def vocoder_key(x, precision: str, up_matmul: bool = False,
                fused_resblocks: bool = True) -> tuple:
    return _resblocks(("vocoder", x.shape[0], x.shape[1], precision, bool(up_matmul)),
                      fused_resblocks)


@dataclasses.dataclass
class Draw:
    """A static input drawn before each replay instead of copied: ``fill``
    writes the buffer of ``shape`` and ``dtype``."""

    shape: tuple
    dtype: torch.dtype
    fill: Callable[[torch.Tensor], object]


def _noise_draw(cfg, b: int, t_pad: int, generator) -> Draw:
    """The noise input: drawn from the call's generator into the static
    buffer with the op of ``synthesis._noise``."""
    return Draw((b, t_pad, cfg.latent_channels), torch.float32,
                lambda out: synthesis._noise(cfg, b, t_pad, generator, out.device, out=out))


def static_like(inputs, device) -> tuple[torch.Tensor, ...]:
    """A static buffer for each input (a tensor or a ``Draw``)."""
    return tuple(torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
                 for x in inputs)


def fill(static, inputs) -> None:
    """Copy each tensor input into its static buffer; draw each ``Draw``."""
    for buf, x in zip(static, inputs):
        if isinstance(x, Draw):
            x.fill(buf)
        else:
            buf.copy_(x)


@dataclasses.dataclass
class Program:
    """One captured graph with its static inputs and outputs, the launches
    its capture recorded, and what the capture took."""

    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    record: dict
    capture_s: float
    pool_bytes: int    # growth of the reserved device memory over the capture
    static_bytes: int  # the static input buffers, outside the pool


class Programs:
    """The captured programs of one engine on one CUDA device."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs run on a CUDA device, not {device}")
        self.device = device
        self._programs: dict[tuple, Program] = {}
        self._capture_lock = threading.Lock()
        # one replay unit (copy-in, replay, clone) at a time: the graphs
        # share one memory pool
        self._replay_lock = threading.Lock()
        self._last = None  # event behind the last replay unit
        self._pool = None
        self._stream = None

    def stats(self) -> list[dict]:
        """Per captured key: capture seconds, pool growth and static bytes."""
        return [dict(key=p.key, capture_s=p.capture_s, pool_bytes=p.pool_bytes,
                     static_bytes=p.static_bytes) for p in self._programs.values()]

    # ------------------------------------------------------------------
    # the three programs, with the signatures of the synthesis functions
    # ------------------------------------------------------------------

    def synthesize_fused(self, params, cfg, text_ids, text_mask, style_dp, style_ttl,
                         generator, speed, total_step: int, t_pad: int, *,
                         precision: str = "bf16", egress: str = "int16",
                         fused_ffn: bool = True, up_matmul: bool = False,
                         fused_resblocks: bool = True, backend=None):
        """``synthesis.synthesize_fused`` through its program; ``speed`` is
        a 0-dim f32 tensor on the device. With a graph ``backend``
        (``assets.onnx_backend``) the program is its ``fused_fn``: the
        captured body is ``backend.padded_fn``, under the same key."""
        noise = _noise_draw(cfg, text_ids.shape[0], t_pad, generator)

        def body(ids, mask, sdp, sttl, spd, nz):
            if backend is not None:
                return backend.padded_fn(params, ids, mask, sdp, sttl, nz, spd,
                                         total_step, egress)
            wav, dur = synthesis.synthesize_padded(
                params, cfg, ids, mask, sdp, sttl, nz, spd, total_step,
                precision=precision, fused_ffn=fused_ffn, up_matmul=up_matmul,
                fused_resblocks=fused_resblocks, egress=egress)
            return synthesis.encode_egress(wav, egress), dur

        key = fused_key(text_ids, total_step, t_pad, precision, egress, fused_ffn, up_matmul,
                        fused_resblocks)
        return self.run(key, body, (text_ids, text_mask, style_dp, style_ttl, speed, noise))

    def flow_fused(self, params, cfg, text_ids, text_mask, style_dp, style_ttl,
                   generator, speed, total_step: int, t_pad: int, *,
                   precision: str = "bf16", halo: int = 0, fused_ffn: bool = True):
        """``synthesis.flow_fused`` through its program."""
        return self.flow_padded(
            params, cfg, text_ids, text_mask, style_dp, style_ttl,
            _noise_draw(cfg, text_ids.shape[0], t_pad, generator), speed, total_step,
            precision=precision, halo=halo, fused_ffn=fused_ffn)

    def flow_padded(self, params, cfg, text_ids, text_mask, style_dp, style_ttl, noise,
                    speed, total_step: int, *, precision: str = "bf16", halo: int = 0,
                    fused_ffn: bool = True, backend=None):
        """``synthesis.flow_padded`` through the ``flow`` program, the noise
        copied into its static buffer: a mesh engine's shard takes its rows
        of the noise drawn once for the whole batch. With a graph
        ``backend`` the body is its ``flow_fn`` (halo 0)."""

        def body(ids, mask, sdp, sttl, spd, nz):
            if backend is not None:
                return backend.flow_fn(params, ids, mask, sdp, sttl, nz, spd, total_step)
            return synthesis.flow_padded(params, cfg, ids, mask, sdp, sttl, nz, spd,
                                         total_step, precision=precision, halo=halo,
                                         fused_ffn=fused_ffn)

        t_pad = noise.shape[1]
        key = flow_key(text_ids, total_step, t_pad, precision, halo, fused_ffn)
        return self.run(key, body, (text_ids, text_mask, style_dp, style_ttl, speed, noise))

    def vocode_window(self, params, cfg, xt_pad, mask_pad, start: int, window: int,
                      halo: int, *, precision: str = "bf16", egress: str = "int16",
                      up_matmul: bool = False, fused_resblocks: bool = True, backend=None):
        """``synthesis.vocode_window`` through its program: the window's
        frames are copied into the static input. With a graph ``backend``
        the vocoder is its ``vocode_fn``."""

        def body(x_win, m_win):
            if backend is not None:
                wav = backend.vocode_fn(params, x_win, m_win)
                chunk = cfg.chunk_size
                return (synthesis.encode_egress(
                    wav[:, halo * chunk:(halo + window) * chunk], egress),)
            return (synthesis.vocode_span(params, cfg, x_win, m_win, window, halo,
                                          precision=precision, egress=egress,
                                          up_matmul=up_matmul,
                                          fused_resblocks=fused_resblocks),)

        (wav,) = self.run(window_key(xt_pad, window, halo, precision, egress, up_matmul,
                                     fused_resblocks),
                          body, synthesis.window_span(xt_pad, mask_pad, start, window, halo))
        return wav

    # -- the injected-noise path: two programs, the host syncs between -----

    def text_stage(self, params, cfg, text_ids, text_mask, style_dp, style_ttl, speed,
                   *, precision: str = "bf16", backend=None):
        """``synthesis.text_stage`` (or ``backend.text_fn``) through its
        program: (duration [B], text_emb)."""

        def body(ids, mask, sdp, sttl, spd):
            if backend is not None:
                return backend.text_fn(params, ids, mask, sdp, sttl, spd)
            return synthesis.text_stage(params, cfg, ids, mask, sdp, sttl, spd,
                                        precision=precision)

        return self.run(text_key(text_ids, precision), body,
                        (text_ids, text_mask, style_dp, style_ttl, speed))

    def acoustic_stage(self, params, cfg, text_emb, style_ttl, text_mask, latent_mask,
                       noise, total_step: int, *, precision: str = "bf16",
                       fused_ffn: bool = True, up_matmul: bool = False,
                       fused_resblocks: bool = True, backend=None, frame_mask=None):
        """``synthesis.acoustic_stage`` (or ``backend.acoustic_fn``) through
        its program: wav [B, T*chunk] f32. A given ``frame_mask`` is one
        more static input, under a key of its own."""

        def body(emb, sttl, tmask, lmask, nz, *fm):
            fm = fm[0] if fm else None
            if backend is not None:
                return (backend.acoustic_fn(params, emb, sttl, tmask, lmask, nz,
                                            total_step, frame_mask=fm),)
            return (synthesis.acoustic_stage(params, cfg, emb, sttl, tmask, lmask, nz,
                                             total_step, precision=precision,
                                             fused_ffn=fused_ffn, up_matmul=up_matmul,
                                             fused_resblocks=fused_resblocks,
                                             frame_mask=fm),)

        key = acoustic_key(text_emb, latent_mask, total_step, precision, fused_ffn,
                           up_matmul, frame_mask is not None, fused_resblocks)
        inputs = (text_emb, style_ttl, text_mask, latent_mask, noise)
        (wav,) = self.run(key, body, inputs + (() if frame_mask is None else (frame_mask,)))
        return wav

    # -- the progress path: the cross K/V once, a step per replay, vocoder --

    def cross_cache(self, params, cfg, text_emb, style_ttl, text_mask, latent_mask, *,
                    precision: str = "bf16", backend=None) -> tuple:
        """``synthesis.cross_cache`` through its program. A graph backend
        has no cache to take out of its opaque graph: ()."""
        if backend is not None:
            return ()

        def body(emb, sttl, tmask, lmask):
            return synthesis.cross_cache(params, cfg, emb, sttl, tmask, lmask,
                                         precision=precision)

        return self.run(cross_key(text_emb, precision, latent_mask), body,
                        (text_emb, style_ttl, text_mask, latent_mask))

    def euler_step(self, params, cfg, x, text_emb, style_ttl, text_mask, latent_mask,
                   current_step, total_step, cache: tuple, *, precision: str = "bf16",
                   fused_ffn: bool = True, backend=None):
        """``synthesis.euler_step`` (or the graph backend's progress step)
        through its program. ``current_step`` is a static input copied in
        before each replay, so one graph serves every step."""

        def body(x, emb, sttl, tmask, lmask, cur, tot, *cache):
            if backend is not None:
                _cross, step_fn, _voc = backend.progress_fns()
                return (step_fn(params, x, emb, sttl, tmask, lmask, cur, tot),)
            return (synthesis.euler_step(params, cfg, x, emb, sttl, tmask, lmask, cur,
                                         tot, cache, precision=precision,
                                         fused_ffn=fused_ffn),)

        (x,) = self.run(step_key(x, text_emb, precision, fused_ffn), body,
                        (x, text_emb, style_ttl, text_mask, latent_mask, current_step,
                         total_step, *cache))
        return x

    def vocode(self, params, cfg, x, frame_mask, *, precision: str = "bf16",
               up_matmul: bool = False, fused_resblocks: bool = True, backend=None):
        """``synthesis.vocode`` (or the graph backend's progress vocoder)
        through its program."""

        def body(x, fm):
            if backend is not None:
                _cross, _step, voc_fn = backend.progress_fns()
                return (voc_fn(params, x, fm),)
            return (synthesis.vocode(params, cfg, x, fm, precision=precision,
                                     up_matmul=up_matmul,
                                     fused_resblocks=fused_resblocks),)

        (wav,) = self.run(vocoder_key(x, precision, up_matmul, fused_resblocks), body,
                          (x, frame_mask))
        return wav

    # ------------------------------------------------------------------
    # capture and replay
    # ------------------------------------------------------------------

    def run(self, key: tuple, body, inputs) -> tuple:
        """Replay the program of ``key`` (captured from ``body`` at first
        use) on ``inputs``; returns fresh copies of its outputs."""
        with torch.cuda.device(self.device):  # one Programs per card of a mesh
            return self._run(key, body, inputs)

    def _run(self, key: tuple, body, inputs) -> tuple:
        prog = self._program(key, body, inputs)
        with self._replay_lock:
            stream = torch.cuda.current_stream(self.device)
            if self._last is not None:
                stream.wait_event(self._last)
            fill(prog.inputs, inputs)
            prog.graph.replay()
            outputs = tuple(out.clone() for out in prog.outputs)
            self._last = torch.cuda.Event()
            self._last.record(stream)
        _count.credit(prog.record)
        return outputs

    def _program(self, key: tuple, body, inputs) -> Program:
        prog = self._programs.get(key)
        if prog is None:
            with self._capture_lock:
                prog = self._programs.get(key)
                if prog is None:
                    prog = self._programs[key] = self._capture(key, body, inputs)
        return prog

    def _capture(self, key: tuple, body, inputs) -> Program:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        side, current = self._stream, torch.cuda.current_stream(self.device)
        static = static_like(inputs, self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # the eager run at this shape, outside the capture: draws are
            # left as zeros, so no generator moves
            fill(static, [torch.zeros_like(s) if isinstance(x, Draw) else x
                          for s, x in zip(static, inputs)])
            body(*static)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with _count.capturing() as record, torch.cuda.graph(
                graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            outputs = tuple(body(*static))
        current.wait_stream(side)
        return Program(key=key, graph=graph, inputs=static, outputs=outputs, record=record,
                       capture_s=time.perf_counter() - t0,
                       pool_bytes=torch.cuda.memory_reserved(self.device) - reserved,
                       static_bytes=sum(s.numel() * s.element_size() for s in static))
