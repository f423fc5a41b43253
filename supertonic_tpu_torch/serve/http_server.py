"""Zero-dependency HTTP service (stdlib http.server), the counterpart of
``supertonic_tpu.serve.http_server`` with the same wire contract:

    GET  /health      -> 200 {"status": "ok"}
    GET  /metrics     -> 200 JSON profiler counters + batcher stats
    GET  /voices      -> 200 {"voices": [...]} (loadable style presets)
    POST /tts         -> single: audio/wav stream; batch: application/zip
                         400 on validation errors {"detail": ...}
                         422 on schema/bounds errors (pydantic-compatible)
    POST /tts/stream  -> chunked-transfer WAV: audio begins flowing after the
                         first vocoder window of the first text chunk
    POST /v1/audio/speech -> the OpenAI-compatible speech surface
    GET  /            -> the built-in browser demo page

Requests are dispatched through the ContinuousBatcher: concurrent requests
coalesce into bucketed device batches, long-form texts are chunked and their
chunks interleave with other traffic, and no lock is ever held while writing
to a client socket (a slow reader cannot stall synthesis for everyone else).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config import AVAILABLE_LANGS
from ..utils import sanitize_filename, wav_bytes
from ..utils.logging import default_logger as log

# largest accepted request body (JSON text batches; ~100x the longest
# sane long-form request). Bodies above this are refused with 413 before
# any buffering.
_MAX_BODY_BYTES = 8 * 1024 * 1024


class ValidationError(Exception):
    def __init__(self, status: int, detail: str):
        self.status = status
        self.detail = detail


def _wav_data_payload(payload: bytes) -> bytes:
    """Extract the 'data' chunk samples from a RIFF WAV byte string by
    walking the chunk list — a fixed 44-byte slice would silently corrupt
    output if the writer ever emitted an extra chunk (LIST/fact) or a
    non-16-byte fmt chunk."""
    import struct

    if payload[:4] != b"RIFF" or payload[8:12] != b"WAVE":
        raise ValidationError(500, "synthesized payload is not RIFF/WAVE")
    off = 12
    while off + 8 <= len(payload):
        cid = payload[off:off + 4]
        size = struct.unpack("<I", payload[off + 4:off + 8])[0]
        if cid == b"data":
            end = len(payload) if size == 0xFFFFFFFF else off + 8 + size
            return payload[off + 8:end]
        off += 8 + size + (size & 1)  # chunks are word-aligned
    raise ValidationError(500, "synthesized WAV has no data chunk")


def drain_body(handler, length: int,
               cap: int = 4 * _MAX_BODY_BYTES) -> None:
    """Read-and-discard up to ``cap`` bytes of an oversized request body
    after refusing it: closing with unread bytes in the kernel buffer sends
    a TCP RST that can destroy the refusal response before the client reads
    it; truly abusive sizes get the RST."""
    remaining = min(length, cap)
    while remaining > 0:
        chunk = handler.rfile.read(min(remaining, 1 << 20))
        if not chunk:
            break
        remaining -= len(chunk)


class GracefulThreadingServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that can DRAIN: it tracks in-flight handler
    threads (daemon_threads means the stdlib won't) so a SIGTERM path can
    stop accepting, close the listener, and wait for active responses to
    finish instead of cutting them with a TCP reset."""

    # stdlib default backlog is 5: concurrent client bursts get their
    # connections refused before a handler thread ever spawns
    request_queue_size = 128
    daemon_threads = True  # abrupt interpreter exit must never hang

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._active: set = set()
        self._active_lock = threading.Lock()

    def process_request_thread(self, request, client_address):
        t = threading.current_thread()
        with self._active_lock:
            self._active.add(t)
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._active_lock:
                self._active.discard(t)

    def join_handlers(self, timeout: float = 65.0) -> bool:
        """Wait for in-flight handlers after shutdown(). True = drained."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._active_lock:
                if not self._active:
                    return True
            time.sleep(0.05)
        return False

    def drain(self, close_cb=None) -> None:
        """Full graceful-drain sequence for a main() exiting serve_forever:
        refuse new connections immediately, wait for in-flight responses,
        then run ``close_cb`` (batcher/router teardown)."""
        self.server_close()  # new connections get refused, not queued
        self.join_handlers()
        if close_cb is not None:
            close_cb()


def _ensure_list(v):
    return v if isinstance(v, list) else [v]


# OpenAI audio-speech voice names -> our presets, so off-the-shelf clients
# of POST /v1/audio/speech work unmodified; our own preset names (M1..F5)
# and style_dir entries are accepted directly.
_OPENAI_VOICE_MAP = {
    "alloy": "F1", "ash": "M4", "ballad": "M5", "coral": "F4",
    "echo": "M1", "fable": "M2", "onyx": "M3", "nova": "F2",
    "sage": "F5", "shimmer": "F3", "verse": "M2",
}


def _parse_speech_request(body: dict) -> dict:
    """OpenAI-compatible POST /v1/audio/speech request: ``input`` (text),
    ``voice``, optional ``response_format`` (wav|pcm), ``speed`` (0.25-4.0).
    Extensions beyond the OpenAI schema: ``lang``, ``total_step``."""
    if not isinstance(body, dict):
        raise ValidationError(422, "request body must be a JSON object")
    text = body.get("input")
    if not isinstance(text, str) or not text:
        raise ValidationError(422, "field 'input' must be a non-empty string")
    voice = body.get("voice", "M1")
    if not isinstance(voice, str):
        raise ValidationError(422, "voice must be a string")
    voice = _OPENAI_VOICE_MAP.get(voice.lower(), voice)
    fmt = body.get("response_format", "wav")
    if fmt not in ("wav", "pcm"):
        raise ValidationError(
            400, f"response_format {fmt!r} not supported (use 'wav' or "
                 f"'pcm'; audio is mono PCM16 at the model's sample rate)")
    speed = body.get("speed", 1.0)
    if (not isinstance(speed, (int, float)) or isinstance(speed, bool)
            or not (0.25 <= speed <= 4.0)):
        raise ValidationError(422, "speed must be a number in [0.25, 4.0]")
    ts = body.get("total_step", 5)
    if not isinstance(ts, int) or isinstance(ts, bool) or not (1 <= ts <= 50):
        raise ValidationError(422, "total_step must be an int in [1, 50]")
    lang = body.get("lang", "en")
    if not isinstance(lang, str):
        raise ValidationError(422, "lang must be a string")
    return {
        "text": text, "lang": lang, "voice_style": voice,
        "total_step": ts, "speed": float(speed), "batch": False,
        "silence_duration": 0.3, "crossfade_duration": 0.0,
        "response_format": fmt,
    }


def _parse_request(body: dict) -> dict:
    if not isinstance(body, dict):
        raise ValidationError(422, "request body must be a JSON object")
    if "text" not in body:
        raise ValidationError(422, "field 'text' is required")
    req = {
        "text": body["text"],
        "lang": body.get("lang", "en"),
        "voice_style": body.get("voice_style", "M1"),
        "total_step": body.get("total_step", 5),
        "speed": body.get("speed", 1.05),
        "batch": bool(body.get("batch", False)),
        "silence_duration": body.get("silence_duration", 0.3),
        "crossfade_duration": body.get("crossfade_duration", 0.0),
    }
    for key in ("text", "lang", "voice_style"):
        vals = _ensure_list(req[key])
        if not vals or not all(isinstance(v, str) for v in vals):
            raise ValidationError(
                422, f"{key} must be a string or a list of strings")
    ts = req["total_step"]
    if not isinstance(ts, int) or isinstance(ts, bool) or not (1 <= ts <= 50):
        raise ValidationError(422, "total_step must be an int in [1, 50]")
    if not (isinstance(req["speed"], (int, float))
            and not isinstance(req["speed"], bool) and req["speed"] > 0):
        raise ValidationError(422, "speed must be > 0")
    for key in ("silence_duration", "crossfade_duration"):
        v = req[key]
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValidationError(422, f"{key} must be a number >= 0")
    return req


class TTSService:
    """Transport-independent request handling. All synthesis goes through
    the ContinuousBatcher; ``use_batcher=False`` serves from the engine
    behind one lock, one request at a time."""

    def __init__(self, tts, *, use_batcher: bool = True,
                 max_batch: int = 32, max_wait_ms: float = 10.0):
        self.tts = tts
        self._style_cache: dict[str, object] = {}
        self._style_lock = threading.Lock()  # cache-only; _lock serializes
        # non-batcher synthesis and CALLS get_style while held
        self._lock = threading.Lock()
        self.batcher = None
        if use_batcher:
            from ..parallel.batcher import ContinuousBatcher

            self.batcher = ContinuousBatcher(
                tts.engine, max_batch=max_batch, max_wait_ms=max_wait_ms)

    def close(self):
        if self.batcher is not None:
            self.batcher.shutdown()
            self.batcher = None

    def get_style(self, name: str):
        # HTTP callers select styles by NAME (presets or style_dir
        # entries). Path separators would turn this into load-any-JSON-on-
        # disk; the CLI keeps full-path freedom for local users.
        # "A+B:t" blends two presets in style-embedding space (t in [0,1],
        # VoiceStyle.blend).
        if "/" in name or "\\" in name or name.startswith("."):
            raise ValidationError(400, f"Unknown voice style: {name!r}")
        with self._style_lock:  # handler threads race on lookup/evict/insert
            hit = self._style_cache.get(name)
        if hit is not None:
            return hit
        try:
            if "+" in name:
                style = self._blend_style(name)
            else:
                style = self.tts.assets.get_voice_style(name)
        except FileNotFoundError as e:
            raise ValidationError(400, str(e))
        with self._style_lock:
            while len(self._style_cache) >= 64:  # bound long-uptime growth
                self._style_cache.pop(next(iter(self._style_cache)))
            self._style_cache[name] = style
        return style

    def _blend_style(self, spec: str):
        """Blend two presets per the shared 'A+B:t' syntax."""
        from ..engine.engine import parse_blend_spec

        try:
            a, b, t = parse_blend_spec(spec)
        except ValueError as e:
            raise ValidationError(400, str(e))
        return self.tts.assets.get_voice_style(a).blend(
            self.tts.assets.get_voice_style(b), t)

    # ------------------------------------------------------------------
    def _validate(self, req: dict) -> tuple[list, list, list]:
        texts = _ensure_list(req["text"])
        langs = _ensure_list(req["lang"])
        styles = _ensure_list(req["voice_style"])
        if req["batch"]:
            if not (len(texts) == len(langs) == len(styles)):
                raise ValidationError(
                    400, "text, lang, and voice_style must have the same length."
                )
        elif len(texts) != 1 or len(langs) != 1 or len(styles) != 1:
            raise ValidationError(
                400, "Non-batch mode requires single text, lang, and voice_style."
            )
        invalid = sorted({l for l in langs if l not in AVAILABLE_LANGS})
        if invalid:
            raise ValidationError(400, f"Invalid language(s): {', '.join(invalid)}")
        return texts, langs, styles

    def _stitch(self, results: list[tuple[np.ndarray, float]],
                silence: float, crossfade: float) -> tuple[np.ndarray, float]:
        from ..engine.stitch import stitch

        return stitch(
            [w for w, _ in results], [d for _, d in results],
            self.tts.sample_rate,
            silence_duration=silence, crossfade_duration=crossfade,
        )

    def _synth_rows_batched(self, texts, langs, styles, total_step, speed):
        """One batcher submission per utterance row; returns trimmed
        (wav, duration) per row, preserving order."""
        futures = [
            self.batcher.submit(t, lng, self.get_style(s), total_step, speed)
            for t, lng, s in zip(texts, langs, styles)
        ]
        return [f.result() for f in futures]

    def _synth_longform_batched(self, text, lang, style_name, req):
        from ..frontend import chunk_text, max_len_for_lang

        chunks = chunk_text(text, max_len=max_len_for_lang(lang))
        if not chunks:
            return np.zeros(0, np.float32), 0.0
        style = self.get_style(style_name)
        futures = [
            self.batcher.submit(c, lang, style, req["total_step"], req["speed"])
            for c in chunks
        ]
        results = [f.result() for f in futures]
        return self._stitch(results, req["silence_duration"],
                            req["crossfade_duration"])

    def synthesize(self, req: dict) -> tuple[bytes, str, str]:
        """Returns (payload, content_type, filename)."""
        texts, langs, styles = self._validate(req)
        engine = self.tts.engine
        sr = self.tts.sample_rate

        if self.batcher is not None:
            if req["batch"]:
                rows = self._synth_rows_batched(
                    texts, langs, styles, req["total_step"], req["speed"])
                chunks = [w for w, _ in rows]
            else:
                wav, _dur = self._synth_longform_batched(
                    texts[0], langs[0], styles[0], req)
                chunks = [wav]
        else:
            with self._lock:
                if req["batch"]:
                    from ..engine.engine import VoiceStyle

                    sts = [self.get_style(s) for s in styles]
                    style = VoiceStyle(
                        np.concatenate([s.ttl for s in sts]),
                        np.concatenate([s.dp for s in sts]),
                    )
                    wav, dur = engine.batch(
                        texts, langs, style, req["total_step"], req["speed"]
                    )
                else:
                    wav, dur = engine(
                        texts[0], langs[0], self.get_style(styles[0]),
                        req["total_step"], req["speed"], req["silence_duration"],
                        req["crossfade_duration"],
                    )
            chunks = engine.trim(wav, dur)

        if len(chunks) == 1:
            fname = sanitize_filename(texts[0], 40) or "tts"
            return wav_bytes(chunks[0], sr), "audio/wav", f"{fname}.wav"

        zbuf = io.BytesIO()
        with zipfile.ZipFile(zbuf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
            for i, chunk in enumerate(chunks):
                fname = sanitize_filename(texts[i], 40) or f"tts_{i + 1}"
                zf.writestr(f"{fname}.wav", wav_bytes(chunk, sr))
        return zbuf.getvalue(), "application/zip", "tts_outputs.zip"

    def stream_chunks(self, req: dict):
        """Yields (trimmed wav [T] f32, duration s) per text chunk as soon as
        it is synthesized. First chunk is dispatched alone for minimum
        time-to-first-audio; the remainder submit together and coalesce with
        any concurrent traffic. No lock is held between yields."""
        texts, langs, styles = self._validate(req)
        if len(texts) != 1 or len(langs) != 1 or len(styles) != 1:
            # batch=true sneaks multi-text past _validate; streaming would
            # silently synthesize texts[0] and drop the rest
            raise ValidationError(
                400, "Streaming requires single text, lang, and voice_style.")
        text, lang = texts[0], langs[0]
        style = self.get_style(styles[0])

        if self.batcher is None:
            # hold the lock only while the generator COMPUTES each piece,
            # never across our own yield (the handler writes to the client
            # socket between yields — a slow reader must not hold the
            # engine lock for everyone else). stream_windows yields the
            # FIRST chunk in vocoder windows (chunk_end=False continuations)
            # so first audio leaves before the chunk finishes vocoding.
            gen = self.tts.engine.stream_windows(
                text, lang, style, req["total_step"], req["speed"])
            while True:
                with self._lock:
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                yield item

        from ..frontend import chunk_text, max_len_for_lang

        chunks = chunk_text(text, max_len=max_len_for_lang(lang))
        if not chunks:
            return
        # the first chunk bypasses the batcher and streams in vocoder
        # windows: first audio leaves after one window's vocoding and copy
        # instead of the whole chunk's. Its device work interleaves with the
        # batcher's on the card (the copies wait on events, never on the
        # other thread's work); the remaining chunks coalesce in the batcher.
        engine = self.tts.engine
        if (getattr(engine, "backend", None) is None
                and hasattr(engine, "_vocode_stream")):
            yield from engine._vocode_stream(
                chunks[0], lang, style, req["total_step"], req["speed"],
                window_frames=64)
        else:  # the graph backend and its adapter stream whole chunks
            first = self.batcher.submit(
                chunks[0], lang, style, req["total_step"], req["speed"])
            wav, dur = first.result()
            yield wav, dur, True
        rest = [
            self.batcher.submit(c, lang, style, req["total_step"], req["speed"])
            for c in chunks[1:]
        ]
        for f in rest:
            wav, dur = f.result()
            yield wav, dur, True

    def stream_wav_bytes(self, req: dict):
        """Transport-independent chunked WAV body: sentinel-size header,
        then PCM16 per synthesized text chunk with silence gaps between.
        Validation (and the first chunk's synthesis) happen in THIS call so
        transports can still emit a clean error response; the returned
        generator only yields bytes. Records time-to-first-audio."""
        import struct

        sr = self.tts.sample_rate
        t0 = time.perf_counter()
        gen = self.stream_chunks(req)
        first = next(gen, None)  # ValidationError propagates before bytes

        def pcm(wav):
            return (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()

        def body():
            yield (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                   + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr,
                                           sr * 2, 2, 16)
                   + b"data" + struct.pack("<I", 0xFFFFFFFF))
            gap = pcm(np.zeros(int(req["silence_duration"] * sr), np.float32))
            # a silence gap belongs BETWEEN text chunks only — pieces with
            # chunk_end=False are vocoder windows continuing the same chunk
            prev_end = False
            if first is not None:
                yield pcm(first[0])
                self.tts.engine.profiler.record_ttfa(
                    time.perf_counter() - t0)
                prev_end = first[2]
            for wav, _dur, chunk_end in gen:
                if prev_end and gap:
                    yield gap
                yield pcm(wav)
                prev_end = chunk_end

        return body()

    def speech(self, body: dict) -> tuple[bytes, str]:
        """OpenAI-compatible speech synthesis: returns (payload, content
        type). WAV by default; ``response_format: "pcm"`` returns raw mono
        PCM16 at the model's sample rate."""
        req = _parse_speech_request(body)
        fmt = req.pop("response_format")
        payload, ctype, _fname = self.synthesize(req)
        if fmt == "pcm":
            return _wav_data_payload(payload), "audio/pcm"
        return payload, ctype

    def voices(self) -> dict:
        """Available voice-style presets; with a mounted voice_styles/ dir,
        what is actually loadable."""
        import glob

        sd = getattr(getattr(self.tts, "assets", None), "style_dir", None)
        if sd:
            names = sorted(
                os.path.splitext(os.path.basename(p))[0]
                for p in glob.glob(os.path.join(sd, "*.json")))
            if names:
                return {"voices": names, "source": "style_dir"}
        from ..config import VOICE_PRESETS

        return {"voices": list(VOICE_PRESETS), "source": "presets"}

    def metrics(self) -> dict:
        out = self.tts.engine.profiler.summary()
        if self.batcher is not None:
            out["batcher"] = dict(self.batcher.stats)
        hbm = _device_memory_stats()
        if hbm:
            out["device_memory"] = hbm
        return out


def _device_memory_stats() -> dict | None:
    """Live device memory (bytes) of every visible card, for capacity
    planning: params, the style cache and in-flight batches all live there,
    and memory pressure shows up here long before it fails a request.
    Reports each card plus the worst in-use/limit ratio across them; None
    without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    rows = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        rows.append({
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_free": free,
            "bytes_limit": total,
        })
    worst = max(r["bytes_in_use"] / r["bytes_limit"] for r in rows)
    return {"devices": rows, "worst_in_use_frac": round(worst, 4)}


def make_server(tts, host: str = "0.0.0.0", port: int = 8000,
                *, use_batcher: bool = True,
                max_batch: int = 32) -> ThreadingHTTPServer:
    service = TTSService(tts, use_batcher=use_batcher, max_batch=max_batch)

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (our /tts/stream framing) is HTTP/1.1-only; the
        # stdlib default advertises HTTP/1.0, which tells strict clients /
        # proxies to read the chunk framing as body bytes
        protocol_version = "HTTP/1.1"
        # dead/stalled clients must not pin a handler thread forever
        timeout = 60

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

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                from .demo_page import DEMO_HTML

                page = DEMO_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
            elif self.path == "/health":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._send_json(200, service.metrics())
            elif self.path == "/voices":
                self._send_json(200, service.voices())
            else:
                self._send_json(404, {"detail": "not found"})

        def _write_chunk(self, data: bytes):
            if not data:
                # a zero-length chunk IS the chunked-transfer terminator;
                # emitting one mid-stream would end the response early and
                # desync keep-alive framing
                return
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _stream_tts(self, req: dict):
            """Chunked WAV via the shared service generator. Synthesis runs
            via the batcher; the socket writes happen on this handler thread
            only, so a slow client throttles nobody but itself."""
            # validation + first-chunk synthesis happen HERE, before headers,
            # so errors still produce a clean JSON response
            body = service.stream_wav_bytes(req)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for data in body:
                    self._write_chunk(data)
                # terminator inside the try: a disconnect between the last
                # chunk and here must not escape the handler either
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
                return
            except Exception as e:  # noqa: BLE001 — headers already sent:
                # a second (JSON 500) response here would be written into
                # the middle of the chunked body; drop the connection
                # without the terminator so the client sees a hard error
                log.error("tts_stream_error",
                          error=f"{type(e).__name__}: {e}")
                self.close_connection = True
                return

        def do_POST(self):
            if self.path not in ("/tts", "/tts/stream", "/v1/audio/speech"):
                self._send_json(404, {"detail": "not found"})
                return
            t0 = time.perf_counter()
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = -1
                if length < 0:
                    # negative would make rfile.read(-1) block until the
                    # socket timeout (read-to-EOF), pinning the handler
                    self._send_json(
                        400, {"detail": "malformed Content-Length"},
                        close=True)
                    return
                if length > _MAX_BODY_BYTES:
                    # refuse to buffer an arbitrarily large request body (a
                    # 1 GB Content-Length would be read into memory before
                    # any validation ran). Drain a bounded amount first:
                    # closing with unread bytes in the kernel buffer sends
                    # a TCP RST that can destroy the 413 before the client
                    # reads it; truly abusive sizes get the RST.
                    self._send_json(413, {
                        "detail": f"request body exceeds "
                                  f"{_MAX_BODY_BYTES} bytes"}, close=True)
                    drain_body(self, length)
                    return
                body = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/v1/audio/speech":
                    # OpenAI-compatible surface (maps its voice names onto
                    # the presets); no Content-Disposition per that API
                    payload, ctype = service.speech(body)
                    fname = None
                else:
                    req = _parse_request(body)
                    if self.path == "/tts/stream":
                        self._stream_tts(req)
                        log.info("tts_stream", latency_s=round(
                            time.perf_counter() - t0, 4))
                        return
                    payload, ctype, fname = service.synthesize(req)
            except ValidationError as e:
                log.warning("tts_rejected", status=e.status, detail=e.detail)
                self._send_json(e.status, {"detail": e.detail})
                return
            except json.JSONDecodeError:
                self._send_json(422, {"detail": "invalid JSON body"})
                return
            except (BrokenPipeError, ConnectionResetError):
                return  # client went away mid-stream; nothing to send
            except Exception as e:  # noqa: BLE001 — wire contract: JSON 500
                log.error("tts_error", error=f"{type(e).__name__}: {e}")
                try:
                    self._send_json(500, {"detail": "internal error"})
                except OSError:
                    pass
                return
            log.info(
                "tts", path=self.path, bytes=len(payload),
                latency_s=round(time.perf_counter() - t0, 4),
            )
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            if fname is not None:
                self.send_header(
                    "Content-Disposition", f'attachment; filename="{fname}"'
                )
            self.end_headers()
            self.wfile.write(payload)

    server = GracefulThreadingServer((host, port), Handler)
    server.service = service  # expose for tests / graceful shutdown
    return server


def main():
    """Serve ``TTS()`` on ``$TTS_HOST:$TTS_PORT`` (default 0.0.0.0:8000).
    Environment: TTS_PLATFORM=cpu runs on the CPU (the default is the card,
    and without one this raises), TTS_ASSETS_DIR (a params.npz bundle or a
    directory of the four ONNX graphs; TTS_ONNX_DIR, the reference
    service's name, is its alias), TTS_PRECISION, TTS_EGRESS (int16 |
    mulaw | f32), TTS_BATCHER=0, TTS_MAX_BATCH, TTS_WARMUP=1."""
    from .. import TTS

    tts = TTS(
        os.getenv("TTS_ASSETS_DIR") or os.getenv("TTS_ONNX_DIR") or None,
        precision=os.getenv("TTS_PRECISION") or None,
        # "mulaw" halves device->host bytes at G.711 speech quality
        egress_format=os.getenv("TTS_EGRESS", "int16"),
        device="cpu" if os.getenv("TTS_PLATFORM") == "cpu" else None,
    )
    host = os.getenv("TTS_HOST", "0.0.0.0")
    port = int(os.getenv("TTS_PORT", "8000"))
    use_batcher = os.getenv("TTS_BATCHER", "1") != "0"
    max_batch = int(os.getenv("TTS_MAX_BATCH", "32"))
    if os.getenv("TTS_WARMUP", "0") != "0":
        # build the kernels and capture the fused program of each shape of
        # the common bucket lattice before accepting traffic. A failure
        # propagates: it would be a kernel that does not build or launch, or
        # a capture that fails.
        rt = tts.cfg.runtime
        bss = tuple(b for b in rt.batch_buckets if b <= max_batch)
        n = tts.engine.warmup(
            batch_sizes=bss,
            progress=lambda i, total: print(f"warmup {i}/{total}"))
        print(f"warmed {n} batch shapes")
    server = make_server(tts, host, port, use_batcher=use_batcher,
                         max_batch=max_batch)
    print(f"Serving Supertonic TTS (PyTorch, {tts.engine.device}) on "
          f"{host}:{port} (batcher={'on' if use_batcher else 'off'})")

    # graceful drain on SIGTERM: stop accepting, let in-flight handlers
    # finish (bounded by the 60 s handler timeout), then shut the batcher
    # down
    import signal

    def _graceful(signum, frame):
        log.info("sigterm_draining")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    server.serve_forever()
    server.drain(close_cb=server.service.close)
    log.info("drained_exit")


if __name__ == "__main__":
    main()
