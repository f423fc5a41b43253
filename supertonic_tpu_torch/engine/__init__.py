from .buckets import latent_len_for_duration, pick_bucket
from .engine import SynthesisEngine, VoiceStyle, resolve_device
from .stitch import stitch
from .synthesis import (
    acoustic_stage,
    synthesize_fused,
    synthesize_padded,
    text_stage,
)

__all__ = [
    "SynthesisEngine",
    "VoiceStyle",
    "acoustic_stage",
    "latent_len_for_duration",
    "pick_bucket",
    "resolve_device",
    "stitch",
    "synthesize_fused",
    "synthesize_padded",
    "text_stage",
]
