"""Dependency-free asyncio HTTP/1.1 server base.

A copy of ``dynamo_tpu/http/base.py``: request parsing (content-length and
chunked), keep-alive, JSON error envelopes. Subclasses implement
``_route`` (the reference splits the same way: axum plumbing vs per-
service routers, lib/llm/src/http/service/service_v2.rs).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

logger = logging.getLogger(__name__)

_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content",
    400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 code: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.message = message
        self.code = code


class HttpServerBase:
    #: reject request bodies larger than this (anti memory-exhaustion: the
    #: body is buffered in full before routing)
    max_body_bytes: int = 64 * 1024 * 1024

    def __init__(self, host: str = "0.0.0.0", port: int = 8080):
        self._host, self._port = host, port
        self._server: Optional[asyncio.base_events.Server] = None
        self.port: int = port

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self._host, self._port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("%s listening on %s:%d", type(self).__name__, self._host, self.port)

    async def run(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _route(self, method, path, headers, body, writer) -> None:
        raise NotImplementedError

    # ---------------- http plumbing ----------------

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except ValueError:
                    # malformed framing (bad content-length / chunk size)
                    await self._send_json(
                        writer, 400,
                        {"error": {"message": "malformed request framing",
                                   "type": "invalid_request_error"}},
                    )
                    break
                if req is None:
                    break
                method, path, headers, body = req
                keep_alive = headers.get("connection", "").lower() != "close"
                try:
                    await self._route(method, path, headers, body, writer)
                except HttpError as e:
                    await self._send_json(
                        writer, e.status,
                        {"error": {"message": e.message, "type": e.code}},
                    )
                except (ConnectionResetError, BrokenPipeError):
                    break
                except Exception as e:  # noqa: BLE001
                    logger.exception("handler error")
                    try:
                        await self._send_json(
                            writer, 500,
                            {"error": {"message": str(e), "type": "internal_error"}},
                        )
                    except (ConnectionResetError, BrokenPipeError):
                        break
                if not keep_alive:
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 — peer may already be gone
                logger.debug("http connection teardown failed", exc_info=True)

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            request_line = await reader.readline()
        except (ConnectionResetError, asyncio.LimitOverrunError):
            return None
        if not request_line:
            return None
        try:
            method, path, _version = request_line.decode().split(None, 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode().partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        length = int(headers.get("content-length", 0) or 0)
        if length > self.max_body_bytes:
            raise ValueError(f"body {length} exceeds limit {self.max_body_bytes}")
        if length:
            body = await reader.readexactly(length)
        elif headers.get("transfer-encoding", "").lower() == "chunked":
            chunks = []
            total = 0
            while True:
                size_line = await reader.readline()
                # RFC 7230: ignore chunk extensions after ';'
                size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
                if size == 0:
                    await reader.readline()
                    break
                total += size
                if total > self.max_body_bytes:
                    raise ValueError(f"chunked body exceeds limit {self.max_body_bytes}")
                chunks.append(await reader.readexactly(size))
                await reader.readline()
            body = b"".join(chunks)
        return method.upper(), path, headers, body

    @staticmethod
    async def _send_response(
        writer: asyncio.StreamWriter,
        status: int,
        body: bytes,
        content_type: str = "application/json",
    ) -> None:
        head = (
            f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        )
        writer.write(head.encode() + body)
        await writer.drain()

    async def _send_json(self, writer, status: int, obj) -> None:
        await self._send_response(writer, status, json.dumps(obj).encode())
