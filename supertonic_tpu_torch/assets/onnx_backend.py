"""Fused SynthesisEngine backend over the generic ONNX-graph executor, the
counterpart of ``supertonic_tpu.assets.onnx_backend``.

``OnnxEngineAdapter`` (engine/onnx_adapter.py) serves the four reference
graphs with the reference's orchestration: each graph call on its own,
3 + total_step host round trips per batch. This module composes the four
executors into the engine's stage functions instead:

  text_fn      duration_predictor + text_encoder
  acoustic_fn  total_step calls of vector_estimator + vocoder
  fused_fn     all four + noise drawn on the device + egress encoding
  padded_fn    fused_fn with the noise as an input: the body that
               ``engine/programs.py`` captures into one CUDA graph per
               static key, as JAX's jit makes fused_fn one program

so a ``SynthesisEngine(..., backend=OnnxStageBackend(...))`` runs the graphs
with no host sync inside a batch and keeps the native engine's machinery:
bucket ladders, the learned speaking rate, the device style cache, sliced
egress, begin/end dispatch, the continuous batcher and /metrics.

Layouts: the engine speaks channel-last ([B, T, C] latents, [B, L] masks);
the graphs speak the reference's channel-first contract ([B, C, T],
[B, 1, L]); the stage functions convert.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import TTSConfig
from .onnx_exec import OnnxExecutor

__all__ = ["ContractMismatch", "OnnxStageBackend", "load_onnx_backend"]


class ContractMismatch(ValueError):
    """Graph inputs deviate from the reference I/O contract. Not an
    asset-corruption error: a structurally different model must fail
    loudly, never be served as something else."""


# the reference I/O contract (input names of each graph)
_CONTRACT = {
    "duration_predictor": ("text_ids", "style_dp", "text_mask"),
    "text_encoder": ("text_ids", "style_ttl", "text_mask"),
    "vector_estimator": ("noisy_latent", "text_emb", "style_ttl", "text_mask",
                         "latent_mask", "current_step", "total_step"),
    "vocoder": ("latent",),
}


def _caller(name: str, exe: OnnxExecutor) -> Callable:
    """Name-keyed invocation of an executor's body (feed order is whatever
    the graph declares; the contract fixes only the name set)."""
    declared = set(exe.input_names)
    expected = set(_CONTRACT[name])
    if declared != expected:
        raise ContractMismatch(
            f"{name}.onnx inputs {sorted(declared)} do not match the "
            f"reference contract {sorted(expected)}")
    if "time_mask" in declared:  # unreachable under _CONTRACT today
        raise ContractMismatch(
            f"{name}.onnx declares an input literally named 'time_mask', "
            "which collides with the executor's reserved padding-mask kwarg")

    def call(weights: dict, time_mask=None, **by_name):
        return exe._run_traced(
            weights, tuple(by_name[n] for n in exe.input_names), time_mask)

    return call


def _meta_tree(tree):
    return {k: (_meta_tree(v) if isinstance(v, dict)
                else torch.empty(v.shape, dtype=v.dtype, device="meta"))
            for k, v in tree.items()}


class OnnxStageBackend:
    """Engine stage functions composed from four ONNX-graph executors.

    ``params`` is the tree the engine passes back into every stage call:
    each graph's device weights by initializer name."""

    def __init__(self, execs: dict[str, OnnxExecutor], cfg: TTSConfig):
        self.cfg = cfg
        self.execs = execs
        self.device = execs["vocoder"].device
        self.params = {name: dict(exe._weights) for name, exe in execs.items()}
        self._call = {name: _caller(name, exe) for name, exe in execs.items()}

    # -- stage bodies (the JAX backend's signatures; torch tensors) --------

    def text_fn(self, params, ids, mask, sdp, sttl, speed):
        """(duration [B] f32 divided by ``speed``, text_emb)."""
        mask3 = mask[:, None, :].float()
        (dur,) = self._call["duration_predictor"](
            params["duration_predictor"],
            text_ids=ids, style_dp=sdp, text_mask=mask3)
        dur = dur.float() / speed
        (emb,) = self._call["text_encoder"](
            params["text_encoder"],
            text_ids=ids, style_ttl=sttl, text_mask=mask3)
        return dur, emb

    def acoustic_fn(self, params, emb, sttl, tmask, lmask, noise, total_step: int):
        """``total_step`` estimator calls (the JAX fori_loop), then the
        vocoder. Returns wav [B, T*chunk] f32."""
        b = lmask.shape[0]
        tmask3 = tmask[:, None, :].float()
        lmask3 = lmask[:, None, :].float()
        # engine noise is channel-last [B, T, C]; graphs take [B, C, T]
        x = (noise.float() * lmask[:, :, None]).permute(0, 2, 1)
        tot = torch.full((b,), float(total_step), dtype=torch.float32, device=x.device)
        for step in range(total_step):
            cur = torch.full((b,), float(step), dtype=torch.float32, device=x.device)
            (x2,) = self._call["vector_estimator"](
                params["vector_estimator"],
                noisy_latent=x, text_emb=emb, style_ttl=sttl,
                text_mask=tmask3, latent_mask=lmask3,
                current_step=cur, total_step=tot)
            if x2.shape != x.shape:
                # the JAX backend's fori_loop requires a fixed carry shape
                raise ValueError(
                    f"vector_estimator maps a latent of {tuple(x.shape)} to "
                    f"{tuple(x2.shape)}: the step loop needs the same shape")
            x = x2.to(x.dtype)
        # batch-max frame mask: the reference vocoder graph is mask-free and
        # runs at batch-max length, but frames past the longest utterance
        # are bucket padding: pre-mask the latent and re-zero them after
        # every conv (the executor's time mask), so bucketed execution
        # equals exact-length execution
        fmask = lmask.float().amax(0)  # [T]
        x = x * fmask[None, None, :]
        (wav,) = self._call["vocoder"](params["vocoder"], latent=x, time_mask=fmask)
        return self._fit_wav(wav, lmask.shape[1])

    def _fit_wav(self, wav, t_frames: int):
        # contract: wav [B, T*chunk]; normalize the width so the engine's
        # egress slicing holds
        want = t_frames * self.cfg.chunk_size
        if wav.shape[1] < want:
            wav = F.pad(wav, (0, want - wav.shape[1]))
        elif wav.shape[1] > want:
            wav = wav[:, :want]
        return wav.float()

    def padded_fn(self, params, ids, mask, sdp, sttl, noise, speed,
                  total_step: int, egress: str):
        """Both stages at the latent length of ``noise`` [B, T, C], the
        latent mask derived on the device from the predicted duration;
        returns (wav in ``egress`` form, duration [B], unclamped)."""
        from ..engine import synthesis as S

        dur, emb = self.text_fn(params, ids, mask, sdp, sttl, speed)
        lmask = S._latent_mask(self.cfg, dur, noise.shape[1])
        wav = self.acoustic_fn(params, emb, sttl, mask, lmask, noise, total_step)
        return S.encode_egress(wav, egress), dur

    def fused_fn(self, params, ids, mask, sdp, sttl, generator, speed,
                 total_step: int, t_pad: int, egress: str):
        """``padded_fn`` on noise [B, t_pad, C] drawn on the device from
        ``generator`` (the op the native engine draws with)."""
        from ..engine import synthesis as S

        noise = S._noise(self.cfg, ids.shape[0], t_pad, generator, ids.device)
        return self.padded_fn(params, ids, mask, sdp, sttl, noise, speed,
                              total_step, egress)

    def validate(self, *, total_step: int = 2, t_pad: int = 32,
                 l_pad: int = 16) -> None:
        """Run the fused body on ``meta`` tensors at tiny shapes: shapes
        only, no device, milliseconds. Raises the UnsupportedOp/ValueError
        a graph would otherwise raise on its first live request, and proves
        that nothing reads a device value on the host (a meta tensor has no
        value), so callers can fall back to the per-call adapter at
        startup."""
        cfg = self.cfg
        meta = torch.device("meta")
        ids = torch.empty((1, l_pad), dtype=torch.int64, device=meta)
        mask = torch.empty((1, l_pad), device=meta)
        sdp = torch.empty((1, cfg.dp.style.n_style, cfg.dp.style.style_value_dim),
                          device=meta)
        sttl = torch.empty((1, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim),
                           device=meta)
        noise = torch.empty((1, t_pad, cfg.latent_channels), device=meta)
        speed = torch.empty((), device=meta)
        wav, dur = self.padded_fn(_meta_tree(self.params), ids, mask, sdp, sttl,
                                  noise, speed, total_step, "int16")
        if tuple(wav.shape) != (1, t_pad * cfg.chunk_size) or tuple(dur.shape) != (1,):
            raise ValueError(f"fused graphs give wav {tuple(wav.shape)} and "
                             f"duration {tuple(dur.shape)}")

    # -- step-at-a-time functions for engine.infer_with_progress -----------

    def progress_fns(self):
        """(cross_fn | None, step_fn, vocoder_fn): no cross-attention cache
        can be taken out of an opaque graph, so cross_fn is None and each
        step runs the whole estimator graph."""

        def _step(params, x, emb, sttl, tmask, lmask, cur, tot, cache=None):
            del cache
            (x2,) = self._call["vector_estimator"](
                params["vector_estimator"],
                noisy_latent=x.permute(0, 2, 1), text_emb=emb,
                style_ttl=sttl, text_mask=tmask[:, None, :].float(),
                latent_mask=lmask[:, None, :].float(),
                current_step=cur, total_step=tot)
            return x2.permute(0, 2, 1).to(x.dtype)

        def _voc(params, x, fm):
            # fm [T]: batch-max frame mask (see acoustic_fn)
            xm = x.permute(0, 2, 1) * fm[None, None, :]
            (wav,) = self._call["vocoder"](params["vocoder"], latent=xm, time_mask=fm)
            return self._fit_wav(wav, x.shape[1])

        return None, _step, _voc


def load_onnx_backend(onnx_dir: str, cfg: TTSConfig, *,
                      matmul_precision: str = "default",
                      bf16_storage: bool | None = None,
                      device=None) -> OnnxStageBackend:
    """The fused stage backend from a directory holding the four reference
    graphs, on ``device`` (default ``cuda``).

    ``matmul_precision``: "float32" for strict f32 products, "default" for
    TF32 on the card. ``bf16_storage``: store MatMul/Conv activations
    bfloat16 inside the graphs. Default: on with "default" precision, off
    with "float32"; ``TTS_ONNX_BF16=0/1``, read here, overrides either way.
    The default is held by the parity floor (wav RMS difference against the
    f32 executor <= 1% of the signal RMS)."""
    import os

    from .onnx_pipeline import load_executors

    if bf16_storage is None:
        env = os.getenv("TTS_ONNX_BF16")
        bf16_storage = (env == "1" if env is not None
                        else matmul_precision != "float32")
    return OnnxStageBackend(
        load_executors(onnx_dir, matmul_precision=matmul_precision,
                       bf16_storage=bf16_storage, device=device), cfg)
