from .buckets import latent_len_for_duration, pick_bucket
from .engine import SynthesisEngine, VoiceStyle, parse_blend_spec, resolve_device
from .stitch import stitch
from .synthesis import (
    acoustic_stage,
    flow_fused,
    flow_stage,
    synthesize_fused,
    synthesize_padded,
    text_stage,
    vocode_window,
)

__all__ = [
    "SynthesisEngine",
    "VoiceStyle",
    "acoustic_stage",
    "flow_fused",
    "flow_stage",
    "latent_len_for_duration",
    "parse_blend_spec",
    "pick_bucket",
    "resolve_device",
    "stitch",
    "synthesize_fused",
    "synthesize_padded",
    "text_stage",
    "vocode_window",
]
