"""Pod-level serving router, a copy of ``supertonic_tpu.serve.router``:
one HTTP front door over N per-host TTS servers. Each host runs the regular
batcher-backed server (serve.http_server); this router sits in front and
provides:

  * **least-expected-wait dispatch** — each request goes to the healthy
    backend minimizing (pending + 1) x EWMA(service time): least-pending
    load balancing that also sheds traffic from a degraded-but-alive
    straggler; an idle-probe window bounds starvation so a recovered host
    earns its way back;
  * **health checking** — a background thread polls ``GET /health`` on every
    backend; failures eject a backend from rotation, recovery re-adds it;
  * **retry on host loss** — connection errors / 5xx responses re-dispatch
    the request to the next-best backend (bounded attempts); a request is
    never retried after response bytes have been forwarded;
  * aggregate ``/health`` (degraded vs ok) and ``/metrics`` (per-backend).

Stdlib-only (http.client + ThreadingHTTPServer), like the HTTP server.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from ..utils.logging import default_logger as log
from .http_server import (GracefulThreadingServer, _MAX_BODY_BYTES, drain_body)


@dataclass
class Backend:
    url: str                      # e.g. "http://10.0.0.2:8000"
    healthy: bool = True
    pending: int = 0
    consecutive_failures: int = 0
    requests: int = 0
    retries_absorbed: int = 0
    # EWMA of observed service time (seconds); None until the first
    # completed request. Drives least-expected-wait dispatch (pick()).
    ewma_s: float | None = None
    last_pick_t: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def hostport(self) -> tuple[str, int]:
        parts = urlsplit(self.url)
        return parts.hostname or "127.0.0.1", parts.port or 80

    def acquire(self):
        with self._lock:
            self.pending += 1
            self.requests += 1

    def release(self):
        with self._lock:
            self.pending -= 1

    def mark_ok(self):
        self.consecutive_failures = 0
        self.healthy = True

    def observe_latency(self, seconds: float):
        """Fold one completed request's service time into the EWMA (0.3 new
        / 0.7 old: a straggler's first slow response already moves its
        estimate most of the way, while one outlier can't poison a healthy
        backend's)."""
        self.ewma_s = (seconds if self.ewma_s is None
                       else 0.3 * seconds + 0.7 * self.ewma_s)

    def mark_failed(self, threshold: int):
        self.consecutive_failures += 1
        if self.consecutive_failures >= threshold:
            if self.healthy:
                log.warning("backend_unhealthy", backend=self.url,
                            failures=self.consecutive_failures)
            self.healthy = False


class _StreamHandle:
    """An in-flight streamed backend response. ``close()`` is idempotent
    and safe at ANY point — including before the chunk generator is ever
    started (closing an un-started generator would skip its finally, which
    is how a header-write failure used to leak the backend's pending
    slot)."""

    def __init__(self, conn, resp, backend):
        self._conn = conn
        self._resp = resp
        self._backend = backend
        self._closed = False

    def close(self):
        if not self._closed:
            self._closed = True
            self._conn.close()
            self._backend.release()

    def chunks(self):
        try:
            while True:
                # read1: return as soon as ANY bytes arrive — read(n)
                # would block until n bytes or EOF, buffering the whole
                # stream and destroying time-to-first-audio
                piece = self._resp.read1(64 * 1024)
                if not piece:
                    break
                yield piece
        finally:
            self.close()


class NoBackendAvailable(Exception):
    pass


class Router:
    """Backend pool + dispatch policy. Transport-independent (the HTTP front
    end below and tests drive it directly)."""

    def __init__(self, backend_urls: list[str], *,
                 failure_threshold: int = 2,
                 health_interval_s: float = 2.0,
                 request_timeout_s: float = 300.0,
                 max_attempts: int | None = None,
                 probe_after_s: float = 15.0):
        if not backend_urls:
            raise ValueError("router needs at least one backend")
        self.backends = [Backend(u.rstrip("/")) for u in backend_urls]
        self.failure_threshold = failure_threshold
        self.health_interval_s = health_interval_s
        self.request_timeout_s = request_timeout_s
        self.max_attempts = max_attempts or len(self.backends)
        # a backend idle & unrouted for this long gets the next request
        # regardless of its latency estimate — a recovered straggler must
        # be able to prove itself again (bounds EWMA-induced starvation)
        self.probe_after_s = probe_after_s
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None

    # ------------------------------------------------------------- lifecycle
    def start_health_loop(self):
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True)
        self._health_thread.start()

    def close(self):
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=self.health_interval_s + 1)

    def _health_loop(self):
        while not self._stop.wait(self.health_interval_s):
            self.check_health()

    def check_health(self):
        """One poll round over all backends (also callable from tests)."""
        for b in self.backends:
            try:
                status, _hdrs, body = self._raw_request(
                    b, "GET", "/health", None, timeout=5.0)
                ok = status == 200
            except (OSError, http.client.HTTPException):
                ok = False
            if ok:
                if not b.healthy:
                    log.info("backend_recovered", backend=b.url)
                b.mark_ok()
            else:
                b.mark_failed(self.failure_threshold)

    # -------------------------------------------------------------- dispatch
    def pick(self, exclude: set[str] = frozenset()) -> Backend:
        """Least-expected-wait dispatch: route to the backend minimizing
        (pending + 1) * EWMA(service time). Pure least-pending keeps
        re-feeding a degraded-but-alive straggler one request at a time the
        moment it goes idle — every such request pays the straggler's full
        latency, putting client p95 AT the straggler's service time.
        Folding the latency estimate in sheds that traffic onto fast
        backends unless their queues grow long enough that waiting is
        genuinely cheaper. Idle-probe (probe_after_s) bounds starvation so
        a recovered host earns its way back."""
        candidates = [b for b in self.backends
                      if b.healthy and b.url not in exclude]
        if not candidates:
            # desperation pass: every backend unhealthy/excluded — try the
            # least-recently-failed one rather than failing outright
            candidates = [b for b in self.backends if b.url not in exclude]
        if not candidates:
            raise NoBackendAvailable("no backend available")
        now = time.time()
        for b in candidates:
            if b.pending == 0 and now - b.last_pick_t > self.probe_after_s:
                b.last_pick_t = now
                return b  # probe: let a long-unrouted idle backend re-prove
        floor = min((b.ewma_s for b in candidates if b.ewma_s is not None),
                    default=None)

        def expected_wait(b: Backend) -> float:
            if b.ewma_s is None:
                # unproven backend: assume it is as fast as the best known
                # (optimistic probe), but never stack a second request on
                # it before the first returns an actual measurement
                return ((b.pending + 1) * (floor or 1.0)
                        if b.pending == 0 else float("inf"))
            return (b.pending + 1) * b.ewma_s

        chosen = min(candidates, key=expected_wait)
        chosen.last_pick_t = now
        return chosen

    def _raw_request(self, backend: Backend, method: str, path: str,
                     body: bytes | None, *, headers: dict | None = None,
                     timeout: float | None = None):
        host, port = backend.hostport
        conn = http.client.HTTPConnection(
            host, port, timeout=timeout or self.request_timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            payload = resp.read()
            return resp.status, dict(resp.getheaders()), payload
        finally:
            conn.close()

    def forward(self, method: str, path: str, body: bytes | None,
                headers: dict | None = None):
        """Dispatch with retry. Returns (status, headers, payload,
        backend_url). Retries connection errors and 5xx on other backends;
        4xx are the client's problem and are returned as-is."""
        tried: set[str] = set()
        last_err: Exception | None = None
        for attempt in range(self.max_attempts):
            try:
                backend = self.pick(exclude=tried)
            except NoBackendAvailable:
                break
            tried.add(backend.url)
            backend.acquire()
            t0 = time.perf_counter()
            try:
                status, hdrs, payload = self._raw_request(
                    backend, method, path, body, headers=headers)
            except (OSError, http.client.HTTPException) as e:
                last_err = e
                backend.mark_failed(self.failure_threshold)
                backend.retries_absorbed += 1
                log.warning("backend_request_failed", backend=backend.url,
                            error=str(e), attempt=attempt + 1)
                continue
            finally:
                backend.release()
            if status >= 500:
                backend.mark_failed(self.failure_threshold)
                backend.retries_absorbed += 1
                last_err = RuntimeError(f"{backend.url} -> {status}")
                continue
            backend.mark_ok()
            if method == "POST" and status < 400:
                # synthesis-shaped work only: 4xx rejections and GET
                # passthroughs return in microseconds and would wash a
                # straggler's estimate back toward zero
                backend.observe_latency(time.perf_counter() - t0)
            return status, hdrs, payload, backend.url
        raise NoBackendAvailable(
            f"all backends failed after {len(tried)} attempts: {last_err}")

    def forward_stream(self, method: str, path: str, body: bytes | None,
                       headers: dict | None = None):
        """Like forward() but yields the backend's response body
        incrementally — /tts/stream keeps its time-to-first-audio through
        the front door instead of being buffered whole. Returns (status,
        headers, chunk_iterator, backend_url). Retries apply only until the
        response headers arrive; once body bytes flow, a backend failure
        truncates the stream (the client sees a short read)."""
        tried: set[str] = set()
        last_err: Exception | None = None
        for attempt in range(self.max_attempts):
            try:
                backend = self.pick(exclude=tried)
            except NoBackendAvailable:
                break
            tried.add(backend.url)
            backend.acquire()
            host, port = backend.hostport
            conn = http.client.HTTPConnection(
                host, port, timeout=self.request_timeout_s)
            t0 = time.perf_counter()
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                backend.release()
                last_err = e
                backend.mark_failed(self.failure_threshold)
                backend.retries_absorbed += 1
                log.warning("backend_request_failed", backend=backend.url,
                            error=str(e), attempt=attempt + 1)
                continue
            if resp.status >= 500:
                resp.read()
                conn.close()
                backend.release()
                backend.mark_failed(self.failure_threshold)
                backend.retries_absorbed += 1
                last_err = RuntimeError(f"{backend.url} -> {resp.status}")
                continue
            backend.mark_ok()
            if method == "POST" and resp.status < 400:
                # streaming: time-to-headers is the per-backend cost signal
                # (the body drains at the client's pace, not the backend's)
                backend.observe_latency(time.perf_counter() - t0)
            handle = _StreamHandle(conn, resp, backend)
            return resp.status, dict(resp.getheaders()), handle, backend.url
        raise NoBackendAvailable(
            f"all backends failed after {len(tried)} attempts: {last_err}")

    # --------------------------------------------------------------- status
    def health(self) -> tuple[int, dict]:
        healthy = [b for b in self.backends if b.healthy]
        status = 200 if healthy else 503
        return status, {
            "status": ("ok" if len(healthy) == len(self.backends)
                       else "degraded" if healthy else "unavailable"),
            "backends": {
                b.url: {"healthy": b.healthy, "pending": b.pending,
                        "requests": b.requests,
                        "retries_absorbed": b.retries_absorbed,
                        "ewma_latency_s": (None if b.ewma_s is None
                                           else round(b.ewma_s, 4))}
                for b in self.backends
            },
        }

    def metrics(self) -> dict:
        out = {"router": self.health()[1]}
        for b in self.backends:
            if not b.healthy:
                continue
            try:
                status, _h, body = self._raw_request(
                    b, "GET", "/metrics", None, timeout=5.0)
                if status == 200:
                    out[b.url] = json.loads(body)
            except (OSError, ValueError, http.client.HTTPException):
                pass
        return out


def make_router_server(router: Router, host: str = "0.0.0.0",
                       port: int = 8080) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (streamed /tts/stream) is HTTP/1.1-only
        protocol_version = "HTTP/1.1"
        timeout = 330

        def log_message(self, *args):
            pass

        def _send_json(self, status: int, obj: dict, *,
                       close: bool = False):
            payload = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            if close:
                # under HTTP/1.1 the client assumes keep-alive unless told
                # otherwise; closing silently makes its NEXT request on
                # this connection fail with a mid-air disconnect
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(payload)

        def _send_forwarded(self, status, hdrs, payload,
                            default_ctype="application/json"):
            lower = {k.lower(): v for k, v in hdrs.items()}
            self.send_response(status)
            self.send_header("Content-Type",
                             lower.get("content-type", default_ctype))
            if "content-disposition" in lower:
                self.send_header("Content-Disposition",
                                 lower["content-disposition"])
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/health":
                status, obj = router.health()
                self._send_json(status, obj)
            elif self.path == "/metrics":
                self._send_json(200, router.metrics())
            elif self.path == "/voices":
                # same surface as the backends: proxy from any healthy one
                try:
                    status, hdrs, payload, _b = router.forward(
                        "GET", "/voices", None)
                except NoBackendAvailable as e:
                    self._send_json(503, {"detail": str(e)})
                    return
                self._send_forwarded(status, hdrs, payload)
            else:
                self._send_json(404, {"detail": "not found"})

        def do_POST(self):
            if self.path not in ("/tts", "/tts/stream", "/v1/audio/speech"):
                self._send_json(404, {"detail": "not found"})
                return
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0:  # negative = rfile.read blocks to socket timeout
                self._send_json(400, {"detail": "malformed Content-Length"},
                                close=True)
                return
            if length > _MAX_BODY_BYTES:
                # same cap as the backends (http_server): don't buffer an
                # arbitrarily large body before forwarding
                self._send_json(413, {
                    "detail": f"request body exceeds "
                              f"{_MAX_BODY_BYTES} bytes"}, close=True)
                drain_body(self, length)
                return
            body = self.rfile.read(length)
            fwd_headers = {"Content-Type": "application/json",
                           "Content-Length": str(len(body))}
            if self.path == "/tts/stream":
                # pass-through streaming: first audio bytes reach the
                # client as the backend produces them (TTFA preserved
                # through the front door)
                try:
                    status, hdrs, handle, backend = router.forward_stream(
                        "POST", self.path, body, headers=fwd_headers)
                except NoBackendAvailable as e:
                    self._send_json(503, {"detail": str(e)})
                    return
                try:
                    self.send_response(status)
                    self.send_header("Content-Type",
                                     hdrs.get("Content-Type", "audio/wav"))
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for piece in handle.chunks():
                        self.wfile.write(f"{len(piece):X}\r\n".encode())
                        self.wfile.write(piece)
                        self.wfile.write(b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True  # client went away
                except (OSError, http.client.HTTPException) as e:
                    # backend died mid-stream: the terminator was never
                    # sent, so the client sees a hard truncation; drop the
                    # connection rather than let the exception escape the
                    # handler (stderr traceback + ambiguous keep-alive)
                    log.warning("routed_stream_truncated", error=str(e))
                    self.close_connection = True
                finally:
                    handle.close()
                log.info("routed_stream", backend=backend, status=status,
                         latency_s=round(time.perf_counter() - t0, 4))
                return
            try:
                status, hdrs, payload, backend = router.forward(
                    "POST", self.path, body, headers=fwd_headers,
                )
            except NoBackendAvailable as e:
                self._send_json(503, {"detail": str(e)})
                return
            log.info("routed", path=self.path, backend=backend,
                     status=status,
                     latency_s=round(time.perf_counter() - t0, 4))
            self._send_forwarded(status, hdrs, payload,
                                 default_ctype="audio/wav")

    server = GracefulThreadingServer((host, port), Handler)
    server.router = router
    return server


def main():
    import os

    urls = [u for u in os.getenv("TTS_BACKENDS", "").split(",") if u]
    if not urls:
        raise SystemExit(
            "set TTS_BACKENDS=http://host1:8000,http://host2:8000")
    router = Router(urls)
    router.check_health()
    router.start_health_loop()
    host = os.getenv("TTS_ROUTER_HOST", "0.0.0.0")
    port = int(os.getenv("TTS_ROUTER_PORT", "8080"))
    server = make_router_server(router, host, port)
    print(f"Routing /tts over {len(urls)} backends on {host}:{port}")

    import signal
    import threading

    def _graceful(signum, frame):
        log.info("router_sigterm_draining")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    server.serve_forever()
    server.drain(close_cb=router.close)
    log.info("router_drained_exit")


if __name__ == "__main__":
    main()
