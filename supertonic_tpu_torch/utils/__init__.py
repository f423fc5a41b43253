from .wav import read_wav, wav_bytes, write_wav

__all__ = ["read_wav", "wav_bytes", "write_wav"]
