"""TARS-compatible TTS HTTP server on stdlib asyncio.

Parity target: serve_tars.py — POST /tts (WAV), POST /tts/stream (chunked
s16le PCM), GET /healthz, GET /readyz; asyncio-semaphore concurrency limit
with 429 on overload (:308-322); sha256 response cache (:229-248); TARS_* env
settings (:52-93). FastAPI/uvicorn are replaced by a minimal HTTP/1.1
implementation — the inference engine itself is the product, not the web
framework.

Engine-agnostic copy for the PyTorch port, with the JAX server's browser
demo (GET / and GET /ui, runtime/webui.py) and its /metrics gauge
`indextts_hbm_in_use_gb`: the bytes PyTorch's allocator holds on the
engine's card (`device`), left out where there is no card, as the JAX
server leaves it out without allocator stats.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from indextts_tpu_torch.utils import audio as audio_utils


@dataclass
class ServerSettings:
    """serve_tars.py Settings (:60-93).

    Env defaults are default_factory so they are read at CONSTRUCTION time
    — a plain default would freeze the env as of module import, silently
    ignoring TARS_* values set between import and server build (the
    reference's pydantic Settings also reads at instantiation)."""

    host: str = "0.0.0.0"
    port: int = 8000
    max_concurrency: int = field(
        default_factory=lambda: int(os.environ.get("TARS_MAX_CONCURRENCY", "1"))
    )
    enable_streaming: bool = field(
        default_factory=lambda: os.environ.get("TARS_ENABLE_STREAMING", "1") != "0"
    )
    reference_audio: str = field(
        default_factory=lambda: os.environ.get("TARS_REFERENCE_AUDIO", "")
    )
    cache_dir: str = field(
        default_factory=lambda: os.environ.get("TARS_CACHE_DIR", "outputs/cache")
    )
    warmup: bool = field(
        default_factory=lambda: os.environ.get("TARS_WARMUP", "1") != "0"
    )


class ResponseCache:
    """sha256(payload) -> wav bytes on disk (core.py:117-120 semantics)."""

    def __init__(self, cache_dir: str):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def key(payload: Dict[str, Any]) -> str:
        blob = json.dumps(payload, sort_keys=True, ensure_ascii=False).encode()
        return hashlib.sha256(blob).hexdigest()

    def get(self, key: str) -> Optional[bytes]:
        p = self.dir / f"{key}.wav"
        if p.exists():
            return p.read_bytes()
        return None

    def put(self, key: str, wav: bytes):
        (self.dir / f"{key}.wav").write_bytes(wav)


def _http_response(
    status: int,
    body: bytes = b"",
    content_type: str = "application/json",
    extra_headers: str = "",
) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found", 429: "Too Many Requests",
              500: "Internal Server Error", 503: "Service Unavailable"}.get(status, "")
    return (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{extra_headers}"
        "Connection: close\r\n\r\n"
    ).encode() + body


class TTSServer:
    """HTTP front over an engine-like object exposing
    synth(text, spk_audio_path, **kw) -> dict with 'audio' (float32) and
    'sampling_rate'. Streaming uses synth_stream(...) -> iterator of chunks.
    """

    def __init__(self, engine_fn: Callable,
                 settings: Optional[ServerSettings] = None,
                 stream_fn: Optional[Callable] = None,
                 device=None):
        # settings default built HERE, not in the signature: a def-time
        # ServerSettings() would freeze the TARS_* env at import
        settings = settings if settings is not None else ServerSettings()
        self.engine_fn = engine_fn
        self.stream_fn = stream_fn
        # the engine's torch device, read by the /metrics memory gauge
        self.device = device
        self.settings = settings
        self.cache = ResponseCache(settings.cache_dir)
        self.sem = asyncio.Semaphore(settings.max_concurrency)
        self.pool = ThreadPoolExecutor(max_workers=max(2, settings.max_concurrency))
        self.ready = False
        self.request_count = 0

    # -- request handling ----------------------------------------------

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode().split()
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", 0))
        if n:
            body = await reader.readexactly(n)
        return method, path, headers, body

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, headers, body = req
            if method == "GET" and (
                path in ("/", "/ui") or path.startswith("/ui?")
            ):
                from indextts_tpu_torch.runtime.webui import render_ui

                lang = None
                if "?" in path:
                    from urllib.parse import parse_qs

                    lang = parse_qs(path.partition("?")[2]).get("lang", [None])[0]
                writer.write(
                    _http_response(
                        200, render_ui(lang).encode(), "text/html; charset=utf-8"
                    )
                )
            elif method == "GET" and path == "/healthz":
                writer.write(_http_response(200, b'{"status":"ok"}'))
            elif method == "GET" and path == "/readyz":
                code = 200 if self.ready else 503
                writer.write(
                    _http_response(code, json.dumps({"ready": self.ready}).encode())
                )
            elif method == "GET" and path == "/metrics":
                writer.write(
                    _http_response(
                        200, self._metrics_text().encode(), "text/plain; version=0.0.4"
                    )
                )
            elif method == "POST" and path == "/tts":
                await self._tts(writer, body, stream=False)
            elif method == "POST" and path == "/tts/stream":
                if not self.settings.enable_streaming:
                    writer.write(_http_response(400, b'{"error":"streaming disabled"}'))
                else:
                    await self._tts(writer, body, stream=True)
            else:
                writer.write(_http_response(404, b'{"error":"not found"}'))
            await writer.drain()
        except Exception as e:  # pragma: no cover - defensive
            try:
                writer.write(
                    _http_response(500, json.dumps({"error": str(e)}).encode())
                )
                await writer.drain()
            except Exception:
                pass
        finally:
            writer.close()

    async def _tts(self, writer: asyncio.StreamWriter, body: bytes, stream: bool):
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError:
            writer.write(_http_response(400, b'{"error":"bad json"}'))
            return
        if "text" not in payload:
            writer.write(_http_response(400, b'{"error":"missing text"}'))
            return

        if self.sem.locked():
            # overload -> 429 (serve_tars.py:312-316)
            writer.write(
                _http_response(429, b'{"error":"server busy, try again later"}')
            )
            return

        async with self.sem:
            self.request_count += 1
            t0 = time.perf_counter()
            if not stream:
                key = self.cache.key(payload)
                cached = self.cache.get(key)
                if cached is not None:
                    writer.write(_http_response(200, cached, "audio/wav"))
                    return
                loop = asyncio.get_running_loop()
                try:
                    result = await loop.run_in_executor(
                        self.pool, lambda: self.engine_fn(**payload)
                    )
                except ValueError as e:
                    # bad request semantics (e.g. use_emo_text without the
                    # Qwen model, missing speaker prompt)
                    writer.write(
                        _http_response(400, json.dumps({"error": str(e)}).encode())
                    )
                    return
                wav = audio_utils.wav_bytes(result["audio"], result["sampling_rate"])
                self.cache.put(key, wav)
                dur = time.perf_counter() - t0
                self.audio_seconds = getattr(self, "audio_seconds", 0.0) + float(
                    result.get("duration_sec", 0.0)
                )
                self.gen_seconds = getattr(self, "gen_seconds", 0.0) + dur
                writer.write(
                    _http_response(
                        200, wav, "audio/wav",
                        extra_headers=f"X-Generation-Time: {dur:.3f}\r\n",
                    )
                )
            else:
                await self._tts_stream(writer, payload)

    async def _tts_stream(self, writer: asyncio.StreamWriter, payload: Dict[str, Any]):
        """Chunked s16le PCM (serve_tars.py:345-438): thread producer feeding
        an asyncio queue.

        Backpressure is credit-based (the producer blocks on a
        threading.Semaphore, never on an asyncio future), so a client
        disconnect mid-stream cannot strand the producer thread: the consumer
        sets `stop` in its finally block and the producer's timed acquire
        observes it and abandons the synthesis generator."""
        import threading

        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        stop = threading.Event()
        credits = threading.Semaphore(8)

        def _post(item) -> None:
            try:
                loop.call_soon_threadsafe(queue.put_nowait, item)
            except RuntimeError:  # loop already closed
                pass

        def producer():
            try:
                for chunk in self.stream_fn(**payload):
                    while not credits.acquire(timeout=0.25):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    _post(("data", chunk))
                _post(("end", None))
            except Exception as e:
                _post(("error", str(e)))

        fut = loop.run_in_executor(self.pool, producer)
        writer.write(
            "HTTP/1.1 200 OK\r\nContent-Type: application/octet-stream\r\n"
            "Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n".encode()
        )
        try:
            while True:
                kind, item = await queue.get()
                if kind in ("end", "error"):
                    break
                pcm = audio_utils.pcm16_bytes(item)
                credits.release()
                writer.write(f"{len(pcm):x}\r\n".encode() + pcm + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
        finally:
            stop.set()
            await fut

    def _metrics_text(self) -> str:
        """Prometheus text exposition (beyond the reference, SURVEY §5 notes
        it ships no Prometheus/OTel)."""
        lines = [
            "# TYPE indextts_requests_total counter",
            f"indextts_requests_total {self.request_count}",
            "# TYPE indextts_audio_seconds_total counter",
            f"indextts_audio_seconds_total {getattr(self, 'audio_seconds', 0.0):.3f}",
            "# TYPE indextts_generation_seconds_total counter",
            f"indextts_generation_seconds_total {getattr(self, 'gen_seconds', 0.0):.3f}",
        ]
        if self.device is not None and torch.device(self.device).type == "cuda":
            lines += [
                "# TYPE indextts_hbm_in_use_gb gauge",
                f"indextts_hbm_in_use_gb {torch.cuda.memory_allocated(self.device) / 1e9:.3f}",
            ]
        return "\n".join(lines) + "\n"

    async def serve(self):
        server = await asyncio.start_server(
            self._handle, self.settings.host, self.settings.port
        )
        self.ready = True
        async with server:
            await server.serve_forever()

    def run(self):
        asyncio.run(self.serve())
