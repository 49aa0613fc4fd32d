"""Two-part wire codec: length-prefixed (header, data) frames.

A copy of ``dynamo_tpu/runtime/codec.py`` (the reference's TwoPartCodec,
lib/runtime/src/pipeline/network/codec/two_part.rs:23-203), byte for byte
on the wire. One frame is:

    magic(2B) | flags(1B) | header_len(u32 BE) | data_len(u64 BE) | header | data

The header is small structured metadata (JSON bytes); the data part is an
opaque payload (serialized request, a KV-block shard, a token batch...).
The u64 data length lets the same framing carry multi-GB KV-cache transfers
as well as tiny control messages.

**Forward compatibility contract**: decoders read the header keys they
know and MUST ignore the rest — a newer peer may add fields (the trace
context's ``traceparent`` rode in this way) and frames from it must still
decode on older builds. Use :meth:`TwoPartMessage.header_field` for
tolerant access; never destructure the header dict exhaustively.
"""

from __future__ import annotations

import asyncio
import json
import struct
from dataclasses import dataclass
from typing import Any, Optional

MAGIC = b"\xD7\x70"  # "dynamo tpu"
_PREFIX = struct.Struct(">2sBIQ")  # magic, flags, header_len, data_len

# Guard against corrupt/hostile frames (ref two_part.rs max-size guard).
MAX_HEADER_BYTES = 16 * 1024 * 1024
MAX_DATA_BYTES = 64 * 1024 * 1024 * 1024

FLAG_NONE = 0x00


class CodecError(Exception):
    pass


@dataclass
class TwoPartMessage:
    header: bytes = b""
    data: bytes = b""

    @staticmethod
    def from_json(obj: Any, data: bytes = b"") -> "TwoPartMessage":
        return TwoPartMessage(header=json.dumps(obj).encode(), data=data)

    def header_json(self) -> Any:
        return json.loads(self.header) if self.header else None

    def header_field(self, key: str, default: Any = None) -> Any:
        """Version-skew-safe header read: the named key if the header is
        a JSON object carrying it, else ``default``. Unknown extra keys
        in the header are — by contract — ignored, and a malformed or
        non-object header reads as "no fields" rather than an exception
        (the frame layer stays decodable even when a peer's header
        schema has drifted)."""
        if not self.header:
            return default
        try:
            obj = json.loads(self.header)
        except ValueError:
            return default
        if not isinstance(obj, dict):
            return default
        return obj.get(key, default)


def encode(msg: TwoPartMessage, flags: int = FLAG_NONE) -> bytes:
    if len(msg.header) > MAX_HEADER_BYTES:
        raise CodecError(f"header too large: {len(msg.header)}")
    if len(msg.data) > MAX_DATA_BYTES:
        raise CodecError(f"data too large: {len(msg.data)}")
    prefix = _PREFIX.pack(MAGIC, flags, len(msg.header), len(msg.data))
    return prefix + msg.header + msg.data


async def read_frame(reader: asyncio.StreamReader) -> Optional[TwoPartMessage]:
    """Read one frame; returns None on clean EOF at a frame boundary."""
    try:
        prefix = await reader.readexactly(_PREFIX.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    magic, _flags, header_len, data_len = _PREFIX.unpack(prefix)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r}")
    if header_len > MAX_HEADER_BYTES or data_len > MAX_DATA_BYTES:
        raise CodecError(f"frame too large: header={header_len} data={data_len}")
    try:
        header = await reader.readexactly(header_len) if header_len else b""
        data = await reader.readexactly(data_len) if data_len else b""
    except asyncio.IncompleteReadError as e:
        raise CodecError("truncated frame") from e
    return TwoPartMessage(header=header, data=data)


def decode_buffer(buf: bytes) -> tuple[TwoPartMessage, bytes]:
    """Decode one frame from a bytes buffer; returns (msg, remainder)."""
    if len(buf) < _PREFIX.size:
        raise CodecError("short buffer")
    magic, _flags, header_len, data_len = _PREFIX.unpack_from(buf)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r}")
    end = _PREFIX.size + header_len + data_len
    if len(buf) < end:
        raise CodecError("short buffer")
    header = buf[_PREFIX.size : _PREFIX.size + header_len]
    data = buf[_PREFIX.size + header_len : end]
    return TwoPartMessage(bytes(header), bytes(data)), buf[end:]


async def write_frame(
    writer: asyncio.StreamWriter, msg: TwoPartMessage, flags: int = FLAG_NONE
) -> None:
    writer.write(encode(msg, flags))
    await writer.drain()



def _byte_view(p) -> memoryview:
    """A flat byte view of one data part: a CPU ``torch`` tensor (any
    dtype, bf16 and e4m3 included), a numpy array, bytes or a memoryview.
    A contiguous tensor is not copied."""
    if hasattr(p, "untyped_storage"):  # a torch tensor
        import torch

        p = p.detach().contiguous().view(-1).view(torch.uint8).numpy()
    return memoryview(p).cast("B")


async def write_frame_parts(
    writer: asyncio.StreamWriter, header: bytes, parts, flags: int = FLAG_NONE
) -> None:
    """One frame whose data section is the concatenation of ``parts``
    (C-contiguous buffers: CPU tensors, arrays, bytes, memoryviews),
    written WITHOUT materializing the joined blob: the KV stream's segment
    frames are tens of MB. Wire-identical to ``write_frame(writer,
    TwoPartMessage(header, b"".join(...)))``; drains once per frame, so a
    sender paces itself to the socket."""
    views = [_byte_view(p) for p in parts]
    data_len = sum(v.nbytes for v in views)
    if len(header) > MAX_HEADER_BYTES:
        raise CodecError(f"header too large: {len(header)}")
    if data_len > MAX_DATA_BYTES:
        raise CodecError(f"data too large: {data_len}")
    writer.write(_PREFIX.pack(MAGIC, flags, len(header), data_len))
    if header:
        writer.write(header)
    for v in views:
        writer.write(v)
    await writer.drain()
