"""Minimal asyncio HTTP/1.1 server (stdlib only).

Copied from `voice_tts_tpu/serving/http.py` (stdlib only; the JAX package's
`serving/__init__` imports pydantic).

fastapi/uvicorn are unavailable in this environment; this module provides the
small HTTP surface the TTS service needs: request parsing with
Content-Length bodies, JSON responses, keep-alive, and a route table.
"""

from __future__ import annotations

import asyncio
import json
from typing import Awaitable, Callable, Dict, Optional, Tuple

MAX_BODY = 512 * 1024 * 1024

Handler = Callable[["Request"], Awaitable["Response"]]


class Request:
    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body.decode("utf-8"))


class Response:
    def __init__(self, payload, status: int = 200,
                 content_type: str = "application/json"):
        self.status = status
        self.payload = payload
        self.content_type = content_type

    def encode(self) -> bytes:
        if self.content_type == "application/json":
            body = json.dumps(self.payload, default=str).encode("utf-8")
        elif isinstance(self.payload, bytes):
            body = self.payload
        else:
            body = str(self.payload).encode("utf-8")
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 408: "Request Timeout",
                  422: "Unprocessable Entity", 500: "Internal Server Error",
                  503: "Service Unavailable", 504: "Gateway Timeout"}.get(
                      self.status, "")
        head = (f"HTTP/1.1 {self.status} {reason}\r\n"
                f"Content-Type: {self.content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Access-Control-Allow-Origin: *\r\n"
                f"Connection: keep-alive\r\n\r\n")
        return head.encode("ascii") + body


class HttpServer:
    def __init__(self):
        self.routes: Dict[Tuple[str, str], Handler] = {}

    def route(self, method: str, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes[(method.upper(), path)] = fn
            return fn
        return deco

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            line = await reader.readline()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            return None
        if not line:
            return None
        try:
            method, path, _ = line.decode("ascii").split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            if b":" in hline:
                k, v = hline.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY:
            return None
        body = await reader.readexactly(length) if length else b""
        return Request(method.upper(), path.split("?")[0], headers, body)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                handler = self.routes.get((req.method, req.path))
                if handler is None:
                    if any(p == req.path for (_, p) in self.routes):
                        resp = Response({"detail": "Method Not Allowed"}, 405)
                    else:
                        resp = Response({"detail": "Not Found"}, 404)
                else:
                    try:
                        resp = await handler(req)
                    except Exception as e:  # noqa: BLE001
                        resp = Response({"detail": f"internal error: {e}"}, 500)
                try:
                    payload = resp.encode()
                except Exception as e:  # noqa: BLE001
                    payload = Response({"detail": f"encode error: {e}"},
                                       500).encode()
                writer.write(payload)
                await writer.drain()
                if req.headers.get("connection", "").lower() == "close":
                    break
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def serve(self, host: str, port: int):
        server = await asyncio.start_server(self._handle, host, port)
        async with server:
            await server.serve_forever()
