"""G.711 mu-law companding, a copy of ``supertonic_tpu.utils.mulaw``
(numpy, host side; the device-side encoder lives in engine/synthesis.py).

8-bit mu-law carries ~13-bit dynamic range — half the egress bytes of int16
at speech-grade quality, and WAV format 7 so files stay player-compatible.
"""

from __future__ import annotations

import numpy as np

_BIAS = 0x84  # 132
_CLIP = 32635


def encode(x: np.ndarray) -> np.ndarray:
    """float32 [-1,1] -> uint8 G.711 mu-law."""
    pcm = np.clip(np.asarray(x, np.float32) * 32767.0, -_CLIP, _CLIP)
    sign = np.where(pcm < 0, 0x80, 0).astype(np.int32)
    mag = np.abs(pcm).astype(np.int32) + _BIAS
    # integer threshold comparisons, bit-identical to the device encoder
    # (engine/synthesis.py) — float log2 disagrees at power-of-two magnitudes
    exp = np.zeros_like(mag)
    for th in (256, 512, 1024, 2048, 4096, 8192, 16384):
        exp = exp + (mag >= th).astype(np.int32)
    mant = (mag >> (exp + 3)) & 0x0F
    return (~(sign | (exp << 4) | mant) & 0xFF).astype(np.uint8)


def decode(b: np.ndarray) -> np.ndarray:
    """uint8 G.711 mu-law -> float32 [-1,1]."""
    inv = (~np.asarray(b).astype(np.int32)) & 0xFF
    sign = inv & 0x80
    exp = (inv >> 4) & 0x07
    mant = inv & 0x0F
    mag = (((mant << 3) + _BIAS) << exp) - _BIAS
    pcm = np.where(sign, -mag, mag).astype(np.float32)
    return pcm / 32767.0
