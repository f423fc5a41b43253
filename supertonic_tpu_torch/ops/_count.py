"""Launch accounting of the kernel wrappers.

Each wrapper calls ``launched(kernel, shape)`` where it launches its kernel.
Outside a CUDA graph capture that counts one launch (``ops.launch_counts``)
and tallies its shape in every open ``ops.record_launches``. While the
calling thread captures a graph (``capturing``), the wrapper's launch is
recorded into the graph and runs only when the graph is replayed: it is
noted in the capture's record instead, and each replay ``credit``s that
record, so the counts and tallies say what the device ran.
"""

from __future__ import annotations

import contextlib
import threading

KERNELS = ("attention", "adaln_ffn", "resblock_chain", "int8_matmul", "w8a8_matmul",
           "quantize", "ln_modulate", "bias_rope", "gated_residual", "conv1d", "linear")

_lock = threading.Lock()
counts = dict.fromkeys(KERNELS, 0)
_tallies: list[dict] = []
_capture = threading.local()  # .record: the capture running on this thread


def _empty() -> dict:
    return {kernel: {} for kernel in KERNELS}


def _add(seen: dict, shapes: dict) -> None:
    for shape, n in shapes.items():
        seen[shape] = seen.get(shape, 0) + n


def launched(kernel: str, shape: tuple) -> None:
    """One launch of ``kernel`` at ``shape`` (the wrapper's shape key)."""
    record = getattr(_capture, "record", None)
    if record is not None:
        _add(record[kernel], {shape: 1})
    else:
        credit({kernel: {shape: 1}})


def credit(record: dict) -> None:
    """Count the launches of ``record`` ({kernel: {shape: launches}}): a
    replayed graph's, or one wrapper's."""
    with _lock:
        for kernel, shapes in record.items():
            counts[kernel] += sum(shapes.values())
            for tally in _tallies:
                _add(tally[kernel], shapes)


@contextlib.contextmanager
def capturing():
    """Within, this thread's launches go to the yielded record, not to the
    counts: the thread is capturing a CUDA graph."""
    record = _empty()
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = None


@contextlib.contextmanager
def record_launches():
    """Within, the launches of every thread, replays included, are tallied
    by shape into the yielded {kernel: {shape: launches}}."""
    tally = _empty()
    with _lock:
        _tallies.append(tally)
    try:
        yield tally
    finally:
        with _lock:
            _tallies[:] = [t for t in _tallies if t is not tally]


def reset() -> None:
    with _lock:
        for kernel in KERNELS:
            counts[kernel] = 0
