from .timing import StageProfiler, sanitize_filename, timer
from .wav import read_wav, wav_bytes, write_wav

__all__ = [
    "StageProfiler",
    "read_wav",
    "sanitize_filename",
    "timer",
    "wav_bytes",
    "write_wav",
]
