"""Long-form chunk stitching.

The reference joins chunk waveforms with a silence gap (py/helper.py:233-244)
and — in the Python port — concatenates *untrimmed padded* chunks, which
inserts vocoder padding garbage mid-utterance; the Rust port trims each chunk
first (rust/src/helper.rs:700-714). We adopt the correct (Rust) behavior and
add an optional equal-power overlap-crossfade join (BASELINE config 4 —
smoother than a hard silence gap for continuous prose).
"""

from __future__ import annotations

import numpy as np


def stitch(
    wavs: list[np.ndarray],
    durations_s: list[float],
    sample_rate: int,
    *,
    silence_duration: float = 0.3,
    crossfade_duration: float = 0.0,
) -> tuple[np.ndarray, float]:
    """Join per-chunk waveforms.

    Each ``wavs[i]`` is a 1-D padded chunk waveform; it is first trimmed to
    ``durations_s[i]`` seconds. Then either joined with ``silence_duration``
    seconds of silence (reference semantics) or overlap-crossfaded with an
    equal-power ramp of ``crossfade_duration`` seconds (our upgrade;
    silence is skipped when crossfading).

    Returns (waveform, total_duration_seconds).
    """
    assert len(wavs) == len(durations_s)
    trimmed = []
    for w, d in zip(wavs, durations_s):
        n = min(len(w), int(sample_rate * d))
        trimmed.append(np.asarray(w[:n], dtype=np.float32))

    if not trimmed:
        return np.zeros(0, np.float32), 0.0
    if len(trimmed) == 1:
        return trimmed[0], len(trimmed[0]) / sample_rate

    if crossfade_duration > 0.0:
        xf = int(crossfade_duration * sample_rate)
        out = trimmed[0]
        for w in trimmed[1:]:
            n = min(xf, len(out), len(w))
            if n == 0:
                out = np.concatenate([out, w])
                continue
            ramp = np.linspace(0.0, np.pi / 2, n, dtype=np.float32)
            fade_out = np.cos(ramp)
            fade_in = np.sin(ramp)
            head, tail = out[:-n], out[-n:]
            mixed = tail * fade_out + w[:n] * fade_in
            out = np.concatenate([head, mixed, w[n:]])
        return out, len(out) / sample_rate

    gap = np.zeros(int(silence_duration * sample_rate), np.float32)
    pieces = []
    for i, w in enumerate(trimmed):
        if i:
            pieces.append(gap)
        pieces.append(w)
    out = np.concatenate(pieces)
    return out, len(out) / sample_rate
