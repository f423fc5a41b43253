"""Length bucketing — XLA shape discipline.

The reference re-runs its graphs at arbitrary (L, T) every call (fine for
ONNX CPU, catastrophic for a trace-once compiler). We pad every dimension up
a fixed ladder so the number of distinct compiled programs is bounded by
|batch_buckets| x |text_buckets| x |latent_buckets| x |step counts| — and in
practice a handful. Masks keep results identical to unpadded execution
(padding-invariance is tested in tests/test_models.py).
"""

from __future__ import annotations

import math
from collections.abc import Sequence


def pick_bucket(value: int, ladder: Sequence[int]) -> int:
    """Smallest ladder entry >= value; beyond the ladder, round up to the
    last entry's granularity (keeps compile count bounded for outliers)."""
    if value <= 0:
        value = 1
    for b in ladder:
        if value <= b:
            return b
    step = ladder[-1]
    return int(math.ceil(value / step) * step)


def quantize_up(value: int, step: int) -> int:
    """Round up to a multiple of ``step`` (bounds the variety of slice
    shapes — every distinct shape is a compiled program)."""
    return -(-value // step) * step


def latent_len_for_duration(
    duration_s: float, sample_rate: int, chunk_size: int
) -> int:
    """T_lat = ceil(dur * sr / chunk) (reference py/helper.py:165-168)."""
    return max(1, math.ceil(duration_s * sample_rate / chunk_size))
