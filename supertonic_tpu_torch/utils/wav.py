"""WAV file I/O without external deps (the reference uses soundfile on Python
and hand-rolled writers in native ports, e.g. cpp/helper.cpp:943-990).

Supports 16-bit PCM (the reference native ports' format) and 32-bit float.
"""

from __future__ import annotations

import io
import struct

import numpy as np


def write_wav(
    path_or_buf, wav: np.ndarray, sample_rate: int, *, fmt: str = "pcm16"
) -> None:
    """Write a mono waveform (float32 in [-1, 1], shape [T]) as WAV."""
    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    if fmt == "pcm16":
        data = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        audio_format, bits = 1, 16
    elif fmt == "float32":
        data = wav.astype("<f4").tobytes()
        audio_format, bits = 3, 32
    else:
        raise ValueError(f"unknown wav format {fmt!r}")

    byte_rate = sample_rate * bits // 8
    block_align = bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, audio_format, 1, sample_rate, byte_rate, block_align, bits
    )
    header += b"data" + struct.pack("<I", len(data))

    if hasattr(path_or_buf, "write"):
        path_or_buf.write(header + data)
    else:
        with open(path_or_buf, "wb") as f:
            f.write(header + data)


def wav_bytes(wav: np.ndarray, sample_rate: int, *, fmt: str = "pcm16") -> bytes:
    buf = io.BytesIO()
    write_wav(buf, wav, sample_rate, fmt=fmt)
    return buf.getvalue()


def read_wav(path_or_buf) -> tuple[np.ndarray, int]:
    """Read a mono/stereo WAV; returns (float32 wav [T] or [T, C], sample_rate)."""
    if hasattr(path_or_buf, "read"):
        raw = path_or_buf.read()
    else:
        with open(path_or_buf, "rb") as f:
            raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt_chunk = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt_chunk = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt_chunk is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt_chunk
    if audio_format == 1 and bits == 16:
        wav = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32767.0
    elif audio_format == 3 and bits == 32:
        wav = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported wav encoding fmt={audio_format} bits={bits}")
    if channels > 1:
        wav = wav.reshape(-1, channels)
    return wav, sample_rate
