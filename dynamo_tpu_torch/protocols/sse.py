"""Server-Sent Events codec.

Re-design of the reference's SSE codec (lib/llm/src/protocols/codec.rs:
16-50): encode JSON payloads as ``data:`` lines with the OpenAI
``data: [DONE]`` terminator, and incrementally parse SSE byte streams back
into events (used by the aggregator tests and by clients).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

DONE = "[DONE]"


@dataclass
class SseEvent:
    data: Optional[str] = None
    event: Optional[str] = None
    comments: list[str] = field(default_factory=list)
    id: Optional[str] = None

    def is_done(self) -> bool:
        return self.data is not None and self.data.strip() == DONE

    def json(self) -> Any:
        if self.data is None:
            return None
        return json.loads(self.data)


def encode_data(obj: Any) -> bytes:
    """data: {json}\n\n"""
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


def encode_event(event: str, obj: Any = None) -> bytes:
    out = b"event: " + event.encode() + b"\n"
    if obj is not None:
        out += b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n"
    return out + b"\n"


def encode_comment(text: str) -> bytes:
    return b": " + text.encode() + b"\n\n"


def encode_done() -> bytes:
    return b"data: [DONE]\n\n"


class SseParser:
    """Incremental SSE parser: feed bytes, iterate complete events."""

    def __init__(self):
        self._buf = b""

    def feed(self, chunk: bytes) -> Iterator[SseEvent]:
        self._buf += chunk
        while True:
            # events are separated by a blank line
            sep = self._find_sep()
            if sep is None:
                return
            block, self._buf = self._buf[: sep[0]], self._buf[sep[1] :]
            ev = self._parse_block(block.decode("utf-8", errors="replace"))
            if ev is not None:
                yield ev

    def _find_sep(self):
        for sep in (b"\r\n\r\n", b"\n\n", b"\r\r"):
            idx = self._buf.find(sep)
            if idx != -1:
                return idx, idx + len(sep)
        return None

    @staticmethod
    def _parse_block(block: str) -> Optional[SseEvent]:
        ev = SseEvent()
        data_lines: list[str] = []
        seen = False
        for line in block.splitlines():
            if not line:
                continue
            seen = True
            if line.startswith(":"):
                ev.comments.append(line[1:].lstrip())
                continue
            if ":" in line:
                fieldname, _, value = line.partition(":")
                value = value[1:] if value.startswith(" ") else value
            else:
                fieldname, value = line, ""
            if fieldname == "data":
                data_lines.append(value)
            elif fieldname == "event":
                ev.event = value
            elif fieldname == "id":
                ev.id = value
        if not seen:
            return None
        if data_lines:
            ev.data = "\n".join(data_lines)
        return ev


def parse_sse_stream(raw: bytes) -> list[SseEvent]:
    p = SseParser()
    events = list(p.feed(raw))
    return events
