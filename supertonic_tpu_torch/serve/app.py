"""HTTP service on FastAPI, the counterpart of ``supertonic_tpu.serve.app``,
API-compatible with the reference FastAPI service (reference py/service.py):

    GET  /health                  -> {"status": "ok"}
    POST /tts                     -> single: WAV stream; batch: ZIP of WAVs
    POST /tts/stream              -> chunked WAV (ours; long-form TTFA)
    GET  /metrics                 -> JSON throughput/latency counters (ours)

Request schema and validation bounds match the reference exactly
(total_step in [1, 50], speed > 0, silence >= 0 — py/service.py:34-39).
All synthesis is delegated to the transport-independent ``TTSService``
(http_server.py), so the FastAPI and stdlib servers share one continuous-
batching dispatch path; the reference synthesizes one request at a time
(py/service.py:97-109).

FastAPI, pydantic and uvicorn are optional: the module imports without
them, and ``create_app`` raises an ImportError that says so. The stdlib
server (``python -m supertonic_tpu_torch.serve.http_server``) serves the
same endpoints without them."""

from __future__ import annotations

import io
import os
from typing import List, Union

from .http_server import TTSService, ValidationError, _MAX_BODY_BYTES


def create_app(tts=None, *, use_batcher: bool = True):
    """Build the FastAPI app. ``tts`` defaults to a TTS() constructed from
    env config (TTS_ASSETS_DIR, TTS_PRECISION; TTS_PLATFORM=cpu for the
    CPU, else the card). Raises ImportError without FastAPI and pydantic."""
    try:
        from fastapi import FastAPI, HTTPException, Request
        from fastapi.responses import JSONResponse, StreamingResponse
        from pydantic import BaseModel, Field
    except ImportError as e:
        raise ImportError(
            "supertonic_tpu_torch.serve.app needs fastapi and pydantic, which "
            "are not installed; `python -m supertonic_tpu_torch.serve.http_server` "
            "serves the same endpoints without them") from e

    if tts is None:
        from .. import TTS

        tts = TTS(
            # TTS_ONNX_DIR: the reference service's env name (py/service.py:20)
            os.getenv("TTS_ASSETS_DIR") or os.getenv("TTS_ONNX_DIR") or None,
            precision=os.getenv("TTS_PRECISION") or None,
            device="cpu" if os.getenv("TTS_PLATFORM") == "cpu" else None,
        )

    service = TTSService(tts, use_batcher=use_batcher)
    app = FastAPI(title="Supertonic TTS Service (PyTorch)")
    app.state.service = service

    @app.middleware("http")
    async def limit_body(request, call_next):  # same 413 as the stdlib server
        if request.method == "POST":
            cl = request.headers.get("content-length")
            if cl is None:
                # chunked transfer has no Content-Length and would bypass
                # the cap entirely; these JSON requests are tiny — require
                # a declared length (411 Length Required)
                return JSONResponse(
                    {"detail": "Content-Length required"}, status_code=411)
            if cl.isdigit() and int(cl) > _MAX_BODY_BYTES:
                return JSONResponse(
                    {"detail": f"request body exceeds "
                               f"{_MAX_BODY_BYTES} bytes"},
                    status_code=413)
        return await call_next(request)

    class TTSRequest(BaseModel):
        text: Union[str, List[str]] = Field(..., description="Text to synthesize.")
        lang: Union[str, List[str]] = Field("en", description="Language(s).")
        voice_style: Union[str, List[str]] = Field("M1", description="Preset name(s) or style path(s).")
        total_step: int = Field(5, ge=1, le=50)
        speed: float = Field(1.05, gt=0.0)
        batch: bool = False
        silence_duration: float = Field(0.3, ge=0.0)
        crossfade_duration: float = Field(0.0, ge=0.0)

    @app.get("/")
    def index():
        from fastapi.responses import HTMLResponse

        from .demo_page import DEMO_HTML

        return HTMLResponse(DEMO_HTML)

    @app.get("/health")
    def health():
        return JSONResponse({"status": "ok"})

    @app.get("/metrics")
    def metrics():
        return JSONResponse(service.metrics())

    @app.get("/voices")
    def voices():
        return JSONResponse(service.voices())

    @app.post("/tts")
    def synthesize(req: TTSRequest):
        try:
            payload, ctype, fname = service.synthesize(req.model_dump())
        except ValidationError as e:
            raise HTTPException(status_code=e.status, detail=e.detail)
        return StreamingResponse(
            io.BytesIO(payload),
            media_type=ctype,
            headers={"Content-Disposition": f'attachment; filename="{fname}"'},
        )

    @app.post("/v1/audio/speech")
    async def speech(request: Request):
        # OpenAI-compatible surface; schema validated by the shared service
        # parser (voice-name mapping, response_format, speed bounds)
        from starlette.concurrency import run_in_threadpool

        try:
            body = await request.json()
        except Exception:
            raise HTTPException(status_code=422, detail="invalid JSON body")
        try:
            # synthesis BLOCKS (batcher future + device sync) — run it in
            # the threadpool like the sync `def` endpoints, or one request
            # freezes the event loop (and /health with it) for its duration
            payload, ctype = await run_in_threadpool(service.speech, body)
        except ValidationError as e:
            raise HTTPException(status_code=e.status, detail=e.detail)
        return StreamingResponse(io.BytesIO(payload), media_type=ctype)

    @app.post("/tts/stream")
    def synthesize_stream(req: TTSRequest):
        try:
            # shared generator: same wire bytes as the stdlib server, same
            # time-to-first-audio metric
            body = service.stream_wav_bytes(req.model_dump())
        except ValidationError as e:
            raise HTTPException(status_code=e.status, detail=e.detail)
        return StreamingResponse(body, media_type="audio/wav")

    return app


def main():
    app = create_app()  # the clear ImportError first
    import uvicorn

    uvicorn.run(
        app,
        host=os.getenv("TTS_HOST", "0.0.0.0"),
        port=int(os.getenv("TTS_PORT", "8000")),
    )


if __name__ == "__main__":
    main()
