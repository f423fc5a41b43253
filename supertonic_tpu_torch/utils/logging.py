"""Structured JSON-line logging, a copy of ``supertonic_tpu.utils.logging``.

One JSON object per line on stderr (or a file): timestamped, levelled,
merge-friendly with log shippers. The HTTP server logs one line per request.
"""

from __future__ import annotations

import json
import sys
import threading
import time


class JsonLogger:
    def __init__(self, stream=None, name: str = "supertonic_tpu_torch"):
        self.stream = stream or sys.stderr
        self.name = name
        self._lock = threading.Lock()

    def log(self, level: str, event: str, **fields):
        rec = {
            "ts": round(time.time(), 3),
            "level": level,
            "logger": self.name,
            "event": event,
            **fields,
        }
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            self.stream.write(line + "\n")
            self.stream.flush()

    def info(self, event: str, **fields):
        self.log("info", event, **fields)

    def warning(self, event: str, **fields):
        self.log("warning", event, **fields)

    def error(self, event: str, **fields):
        self.log("error", event, **fields)


default_logger = JsonLogger()
