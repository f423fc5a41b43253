"""Timers and per-stage profiling counters, a copy of
``supertonic_tpu.utils.timing``: a wall-clock context manager and a stage
profiler whose counters are the serving metrics: per-stage seconds, RTF,
chars/sec, audio-sec/s, request latency and time-to-first-audio
percentiles. ``device_trace`` is the counterpart of the JAX package's
``jax.profiler`` trace: a ``torch.profiler`` trace of the host and, with a
card, the device, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field


@contextlib.contextmanager
def timer(name: str, verbose: bool = True):
    start = time.perf_counter()
    if verbose:
        print(f"{name}...")
    yield
    if verbose:
        print(f"  -> {name} completed in {time.perf_counter() - start:.2f} sec")


@dataclass
class StageProfiler:
    """Accumulates wall time per pipeline stage (frontend / dp / text_enc /
    flow / vocoder / egress) plus synthesis totals and per-request latency
    percentiles (p50 time-to-audio is a BASELINE metric).

    Thread-safe: the engine compute thread, the batcher egress pool, and
    HTTP handler threads all record concurrently. Latency semantics:
    ``latencies_s`` holds per-REQUEST end-to-end seconds (submit→audio on
    host); ``ttfa_s`` holds time-to-FIRST-audio for streaming responses
    (first chunk flushed, not whole synthesis)."""

    stages: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    counters: dict = field(default_factory=lambda: defaultdict(int))
    # percentile windows are BOUNDED (sliding window of the most recent
    # samples): an unbounded list leaks memory in a long-lived server and
    # makes np.percentile cost grow with uptime. Totals keep counting in
    # n_requests / n_streams.
    latencies_s: object = field(default_factory=lambda: deque(maxlen=10000))
    ttfa_s: object = field(default_factory=lambda: deque(maxlen=10000))
    n_requests: int = 0
    n_streams: int = 0
    audio_seconds: float = 0.0
    chars: int = 0
    synth_seconds: float = 0.0

    def __post_init__(self):
        import threading

        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                self.stages[name] += dt
                self.counts[name] += 1

    def bump(self, counter: str, n: int = 1):
        """Increment a named event counter (bucket_overflows, …)."""
        with self._lock:
            self.counters[counter] += n

    def record_throughput(self, audio_seconds: float, chars: int,
                          synth_seconds: float):
        """Batch-level throughput accounting (no request latency) — used by
        the device-resident egress path where per-request latency is
        recorded separately at egress completion."""
        with self._lock:
            self.audio_seconds += audio_seconds
            self.chars += chars
            self.synth_seconds += synth_seconds

    def record_result(self, audio_seconds: float, chars: int, synth_seconds: float):
        self.record_throughput(audio_seconds, chars, synth_seconds)
        with self._lock:
            self.latencies_s.append(synth_seconds)
            self.n_requests += 1

    def record_request_latency(self, latency_s: float):
        """Per-request end-to-end latency (submit → trimmed audio on host)."""
        with self._lock:
            self.latencies_s.append(latency_s)
            self.n_requests += 1

    def record_ttfa(self, seconds: float):
        """Time-to-first-audio for a streaming response."""
        with self._lock:
            self.ttfa_s.append(seconds)
            self.n_streams += 1

    @staticmethod
    def _percentile(values: list, pct: float) -> float:
        if not values:
            return 0.0
        import numpy as np

        return float(np.percentile(np.asarray(list(values)), pct))

    def latency_percentile(self, pct: float) -> float:
        with self._lock:
            snap = list(self.latencies_s)
        return self._percentile(snap, pct)

    @property
    def rtf(self) -> float:
        # 0.0, not inf, before any audio: json.dumps would serialize inf as
        # the non-standard token `Infinity`, making GET /metrics unparseable
        # by strict JSON consumers
        return self.synth_seconds / self.audio_seconds if self.audio_seconds else 0.0

    @property
    def chars_per_sec(self) -> float:
        return self.chars / self.synth_seconds if self.synth_seconds else 0.0

    @property
    def audio_sec_per_sec(self) -> float:
        return self.audio_seconds / self.synth_seconds if self.synth_seconds else 0.0

    def summary(self) -> dict:
        with self._lock:  # deques raise if mutated during iteration
            lat = list(self.latencies_s)
            ttfa = list(self.ttfa_s)
            out = {
                "stages_s": dict(self.stages),
                "counters": dict(self.counters),
                "rtf": self.rtf,
                "chars_per_sec": self.chars_per_sec,
                "audio_sec_per_sec": self.audio_sec_per_sec,
                "audio_seconds": self.audio_seconds,
                "synth_seconds": self.synth_seconds,
                "requests": self.n_requests,
                "streams": self.n_streams,
            }
        out["latency_p50_s"] = self._percentile(lat, 50)
        out["latency_p95_s"] = self._percentile(lat, 95)
        out["ttfa_p50_s"] = self._percentile(ttfa, 50)
        out["ttfa_p95_s"] = self._percentile(ttfa, 95)
        return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block under ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace (view it in
    Perfetto or chrome://tracing) to ``logdir``/trace_<pid>_<ms>.json.
    Yields the profiler; its ``trace_path`` names the file."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def sanitize_filename(text: str, max_len: int) -> str:
    """Replace non-word chars with underscores (reference py/helper.py:378-385)."""
    import re

    return re.sub(r"[^\w]", "_", text[:max_len], flags=re.UNICODE)
