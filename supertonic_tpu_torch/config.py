"""Configuration schema for the Supertonic-TPU framework.

Mirrors the reference ``tts.json`` schema (reconstructed from the Go port's
typed structs, reference ``go/helper.go:25-84``), extended with model
hyper-parameters needed to *define* the networks (the reference ships them
frozen inside ONNX graphs, so it never needed them in config) and TPU
execution options (precision, bucketing, mesh axes).

Only four values of the reference schema are consumed at inference time
(reference ``py/helper.py:156-159``): ``ae.sample_rate``,
``ae.base_chunk_size``, ``ttl.chunk_compress_factor``, ``ttl.latent_dim``.
We honor the full schema for round-tripping real ``tts.json`` files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

AVAILABLE_LANGS = ("en", "ko", "es", "pt", "fr")

# Voice style presets shipped by the reference (reference web/index.html:31-41).
VOICE_PRESETS = ("M1", "M2", "M3", "M4", "M5", "F1", "F2", "F3", "F4", "F5")


@dataclasses.dataclass(frozen=True)
class SpecProcessorConfig:
    """STFT/mel front of the speech autoencoder (training-time only; kept for
    schema parity with reference go/helper.go:31-39)."""

    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 512
    n_mels: int = 128
    eps: float = 1e-5
    norm_mean: float = -4.0
    norm_std: float = 4.0


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Speech autoencoder geometry (reference go/helper.go:25-45)."""

    sample_rate: int = 44100
    base_chunk_size: int = 512
    spec_processor: SpecProcessorConfig = dataclasses.field(
        default_factory=SpecProcessorConfig
    )


@dataclasses.dataclass(frozen=True)
class StyleTokenLayerConfig:
    """Shape of the pre-computed style-token tensors (reference
    go/helper.go:47-53; voice style JSONs carry [1, n_style, style_value_dim])."""

    n_style: int = 50
    style_value_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TTLConfig:
    """Text-to-latent module geometry (reference go/helper.go:55-70)."""

    chunk_compress_factor: int = 4
    latent_dim: int = 24
    style: StyleTokenLayerConfig = dataclasses.field(
        default_factory=StyleTokenLayerConfig
    )
    # proj_out of the text encoder (reference go/helper.go:64-68)
    proj_out_idim: int = 256
    proj_out_odim: int = 512


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Duration-predictor geometry (reference go/helper.go:72-84)."""

    latent_dim: int = 24
    chunk_compress_factor: int = 4
    style: StyleTokenLayerConfig = dataclasses.field(
        default_factory=lambda: StyleTokenLayerConfig(n_style=50, style_value_dim=128)
    )


# ---------------------------------------------------------------------------
# Model hyper-parameters (ours — the reference freezes these inside ONNX).
# Defaults are sized so the total parameter count matches the published
# 66 M budget (reference README.md:60): 66.37 M total = duration predictor
# 4.84 M + text encoder 7.67 M + vector estimator 40.76 M + vocoder 13.11 M.
# The extra depth (vs the pre-r4 63.2 M config) goes to the text encoder and
# duration predictor — the once-per-request stages outside the O(total_step)
# flow loop — so the budget match costs the least flow-loop FLOPs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TextEncoderHParams:
    vocab_size: int = 2048
    dim: int = 256
    n_layers: int = 6
    n_heads: int = 4
    ffn_mult: int = 4
    conv_kernel: int = 5


@dataclasses.dataclass(frozen=True)
class DurationPredictorHParams:
    vocab_size: int = 2048
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    ffn_mult: int = 4


@dataclasses.dataclass(frozen=True)
class VectorEstimatorHParams:
    dim: int = 512
    n_layers: int = 6
    n_heads: int = 8
    ffn_mult: int = 4
    time_embed_dim: int = 256
    # LARoPE base for text/latent cross-attention (arXiv:2509.11084)
    larope_theta: float = 10000.0
    larope_scale: float = 1024.0  # normalized positions are scaled into [0, scale)


@dataclasses.dataclass(frozen=True)
class VocoderHParams:
    dim: int = 512
    # Conv-stage upsample factors. Their product must DIVIDE chunk_size
    # (= ae.base_chunk_size * ttl.chunk_compress_factor, reference
    # py/helper.py:167); the remaining chunk_size/prod samples per step are
    # emitted by the final subpixel projection head (see models/vocoder.py —
    # convs never run at audio sample rate on TPU).
    upsample_factors: tuple[int, ...] = (8, 8)
    # Channel width after each upsample stage (keep >=128: lane-friendly).
    channels: tuple[int, ...] = (256, 128)
    resblock_kernel: int = 3
    resblock_dilations: tuple[int, ...] = (1, 3, 9)
    stage_kernel: int = 5


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """TPU execution options (no analog in the reference)."""

    # "f32" = strict float32 matmuls for parity gates; "bf16" = fast path;
    # "int8" = W8A8 estimator-block matmuls (models.quantize_params), bf16
    # elsewhere — the max-throughput serving point.
    precision: str = "bf16"
    # Text-length bucket ladder (characters incl. lang tags): pad L up to one of
    # these to bound XLA recompiles.
    text_buckets: tuple[int, ...] = (32, 64, 128, 192, 256, 320, 384)
    # Latent-length bucket ladder (frames). Do NOT densify with
    # non-power-of-two-friendly rungs: a 240 bucket (6% fewer elements than
    # 256) measured 6% SLOWER end-to-end in an interleaved A/B (64.2 vs
    # 60.5 ms/batch at b64/5-step, round 4) — XLA/MXU tiling of the
    # T-dimension matmuls loses more on a 240-shape than the padding costs.
    latent_buckets: tuple[int, ...] = (64, 128, 192, 256, 320, 448, 640)
    # Batch-size bucket ladder. Deliberately coarse (4x steps): every rung
    # is one more compiled program per (L, T, steps) combination, and padding
    # a 2-row batch to 4 costs microseconds while a compile costs seconds
    # (minutes through a remote-compile tunnel).
    batch_buckets: tuple[int, ...] = (1, 4, 16, 32, 64, 128)
    # Mesh axis names for data/tensor parallelism.
    data_axis: str = "data"
    model_axis: str = "model"


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    ae: AEConfig = dataclasses.field(default_factory=AEConfig)
    ttl: TTLConfig = dataclasses.field(default_factory=TTLConfig)
    dp: DPConfig = dataclasses.field(default_factory=DPConfig)
    text_encoder: TextEncoderHParams = dataclasses.field(
        default_factory=TextEncoderHParams
    )
    duration_predictor: DurationPredictorHParams = dataclasses.field(
        default_factory=DurationPredictorHParams
    )
    vector_estimator: VectorEstimatorHParams = dataclasses.field(
        default_factory=VectorEstimatorHParams
    )
    vocoder: VocoderHParams = dataclasses.field(default_factory=VocoderHParams)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    # --- derived geometry (reference py/helper.py:161-175) ---
    @property
    def sample_rate(self) -> int:
        return self.ae.sample_rate

    @property
    def chunk_size(self) -> int:
        """Waveform samples per latent frame."""
        return self.ae.base_chunk_size * self.ttl.chunk_compress_factor

    @property
    def latent_channels(self) -> int:
        """Channel dim of the flow latent: latent_dim * chunk_compress_factor."""
        return self.ttl.latent_dim * self.ttl.chunk_compress_factor

    def __post_init__(self):
        import math

        up = math.prod(self.vocoder.upsample_factors)
        if self.chunk_size % up != 0:
            raise ValueError(
                f"prod(vocoder.upsample_factors)={up} must divide "
                f"chunk_size={self.chunk_size}"
            )
        if len(self.vocoder.upsample_factors) != len(self.vocoder.channels):
            raise ValueError("vocoder upsample_factors and channels length mismatch")
        if self.text_encoder.dim != self.ttl.proj_out_idim:
            raise ValueError(
                f"text_encoder.dim={self.text_encoder.dim} must equal "
                f"ttl.proj_out_idim={self.ttl.proj_out_idim} (proj_out maps "
                f"the encoder width, reference go/helper.go:64-68)")


def _dataclass_from_dict(cls, data: dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in data.items():
        if key not in fields:
            continue
        ftype = fields[key].type
        default = fields[key].default_factory() if fields[key].default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            kwargs[key] = _dataclass_from_dict(type(default), val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


def load_tts_json(path: str) -> TTSConfig:
    """Load a reference-format ``tts.json`` (schema per go/helper.go:25-84),
    mapping its nested keys onto :class:`TTSConfig`. Unknown keys are ignored;
    missing keys keep our defaults."""
    with open(path) as f:
        raw = json.load(f)
    return tts_config_from_reference_dict(raw)


def tts_config_from_reference_dict(raw: dict[str, Any]) -> TTSConfig:
    ae_raw = dict(raw.get("ae", {}))
    enc = ae_raw.pop("encoder", {}) or {}
    spec = enc.get("spec_processor", {}) or {}
    ae = _dataclass_from_dict(
        AEConfig, {**ae_raw, "spec_processor": spec}
    )

    ttl_raw = dict(raw.get("ttl", {}))
    style_tl = ((ttl_raw.pop("style_encoder", {}) or {}).get("style_token_layer", {})) or {}
    proj = ((ttl_raw.pop("text_encoder", {}) or {}).get("proj_out", {})) or {}
    ttl = TTLConfig(
        chunk_compress_factor=ttl_raw.get("chunk_compress_factor", 4),
        latent_dim=ttl_raw.get("latent_dim", 24),
        style=_dataclass_from_dict(StyleTokenLayerConfig, style_tl),
        proj_out_idim=proj.get("idim", 256),
        proj_out_odim=proj.get("odim", 512),
    )

    dp_raw = dict(raw.get("dp", {}))
    dp_style = ((dp_raw.pop("style_encoder", {}) or {}).get("style_token_layer", {})) or {}
    dp = DPConfig(
        latent_dim=dp_raw.get("latent_dim", ttl.latent_dim),
        chunk_compress_factor=dp_raw.get(
            "chunk_compress_factor", ttl.chunk_compress_factor
        ),
        style=_dataclass_from_dict(StyleTokenLayerConfig, dp_style),
    )

    # Re-derive a consistent vocoder factor stack for the (possibly different)
    # chunk size described by the file, with a matching channel ladder.
    chunk = ae.base_chunk_size * ttl.chunk_compress_factor
    default_voc = VocoderHParams()
    import math

    default_up = math.prod(default_voc.upsample_factors)
    if chunk % default_up != 0 or chunk // default_up < 16:
        # re-factorize when the default stack doesn't divide the foreign
        # chunk OR would leave the subpixel head under its 16-sample floor
        # (the _factorize_upsample contract — convs stay on coarse
        # timelines, models/vocoder.py)
        factors = _factorize_upsample(chunk)
        chans = tuple(
            max(default_voc.dim // (2 ** (i + 1)), 128) for i in range(len(factors))
        )
        vocoder = dataclasses.replace(
            default_voc, upsample_factors=factors, channels=chans
        )
    else:
        vocoder = default_voc
    # proj_out.idim IS the text-encoder width in the reference schema
    # (go/helper.go:64-68): a foreign idim must re-derive the encoder dim,
    # or the proj_out matmul is shape-incoherent (caught by the config
    # drill, tests/test_config_drill.py)
    te_defaults = TextEncoderHParams()
    if ttl.proj_out_idim % te_defaults.n_heads:
        # fail at config level with the field names, not as a raw reshape
        # size mismatch deep inside attention head splitting
        raise ValueError(
            f"ttl.text_encoder.proj_out.idim={ttl.proj_out_idim} is not "
            f"divisible by the text encoder's n_heads="
            f"{te_defaults.n_heads}; the encoder width cannot split into "
            f"attention heads")
    text_encoder = dataclasses.replace(te_defaults, dim=ttl.proj_out_idim)
    return TTSConfig(ae=ae, ttl=ttl, dp=dp, vocoder=vocoder,
                     text_encoder=text_encoder)


def _factorize_upsample(chunk: int, min_final_depth: int = 16) -> tuple[int, ...]:
    """Pick conv-stage factors whose product times the subpixel head depth
    equals ``chunk``, leaving >= min_final_depth samples/step to the head
    (convs stay on coarse timelines — see models/vocoder.py)."""
    factors: list[int] = []
    n = chunk
    while n >= min_final_depth * 8 and n % 8 == 0 and len(factors) < 2:
        factors.append(8)
        n //= 8
    while n >= min_final_depth * 4 and n % 4 == 0 and len(factors) < 3:
        factors.append(4)
        n //= 4
    return tuple(factors) if factors else (1,)


def to_reference_dict(cfg: TTSConfig) -> dict[str, Any]:
    """Serialize back to the reference ``tts.json`` nesting."""
    sp = cfg.ae.spec_processor
    return {
        "ae": {
            "sample_rate": cfg.ae.sample_rate,
            "base_chunk_size": cfg.ae.base_chunk_size,
            "encoder": {"spec_processor": dataclasses.asdict(sp)},
        },
        "ttl": {
            "chunk_compress_factor": cfg.ttl.chunk_compress_factor,
            "latent_dim": cfg.ttl.latent_dim,
            "style_encoder": {
                "style_token_layer": dataclasses.asdict(cfg.ttl.style)
            },
            "text_encoder": {
                "proj_out": {
                    "idim": cfg.ttl.proj_out_idim,
                    "odim": cfg.ttl.proj_out_odim,
                }
            },
        },
        "dp": {
            "latent_dim": cfg.dp.latent_dim,
            "chunk_compress_factor": cfg.dp.chunk_compress_factor,
            "style_encoder": {
                "style_token_layer": dataclasses.asdict(cfg.dp.style)
            },
        },
    }
