"""Two-part frame codec for the streaming response plane, a copy of
``dynamo_tpu/runtime/codec.py`` (byte for byte the reference's frames).

Frame layout: a fixed 24-byte prelude — ``header_len`` (u64 LE),
``body_len`` (u64 LE), ``xxh3_64(header || body)`` (u64 LE) — then the
header bytes (a msgpack control map) and the body bytes (an opaque
payload). The checksum guards the response plane against corruption or
desync on long-lived raw TCP streams.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field
from typing import Optional

import msgpack
import xxhash

from . import wire

PRELUDE = struct.Struct("<QQQ")
PRELUDE_SIZE = PRELUDE.size  # 24
MAX_MESSAGE = 256 * 1024 * 1024


class CodecError(RuntimeError):
    pass


@dataclass
class TwoPartMessage:
    header: dict = field(default_factory=dict)
    body: bytes = b""


def encode(msg: TwoPartMessage) -> bytes:
    if wire.validation_enabled():
        wire.validate_outgoing(msg.header)
    header = msgpack.packb(msg.header, use_bin_type=True)
    body = msg.body or b""
    h = xxhash.xxh3_64()
    h.update(header)
    h.update(body)
    return PRELUDE.pack(len(header), len(body), h.intdigest()) + header + body


def encode_parts(header: dict, body_parts=()) -> list:
    """The same frame as :func:`encode` with the body given as a sequence
    of buffer-protocol parts, hashed and emitted in place (no join copy).
    Returns the buffer list for ``StreamWriter.writelines``; a
    :func:`decode` on the other end sees one body of the parts."""
    if wire.validation_enabled():
        wire.validate_outgoing(header)
    hdr = msgpack.packb(header, use_bin_type=True)
    h = xxhash.xxh3_64()
    h.update(hdr)
    parts = []
    body_len = 0
    for p in body_parts:
        mv = p if isinstance(p, (bytes, memoryview)) else memoryview(p)
        if isinstance(mv, memoryview) and (mv.ndim != 1 or mv.itemsize != 1):
            mv = mv.cast("B")
        h.update(mv)
        body_len += len(mv)
        parts.append(mv)
    return [PRELUDE.pack(len(hdr), body_len, h.intdigest()) + hdr, *parts]


def _checked_message(header: bytes, body: bytes,
                     checksum: int) -> TwoPartMessage:
    h = xxhash.xxh3_64()
    h.update(header)
    h.update(body)
    if h.intdigest() != checksum:
        raise CodecError("two-part frame checksum mismatch")
    return TwoPartMessage(msgpack.unpackb(header, raw=False), body)


async def decode(reader: asyncio.StreamReader) -> TwoPartMessage:
    """Read one frame (callers bound the wait, or it is an idle read)."""
    prelude = await reader.readexactly(PRELUDE_SIZE)
    header_len, body_len, checksum = PRELUDE.unpack(prelude)
    if header_len + body_len > MAX_MESSAGE:
        raise CodecError(f"message too large: {header_len + body_len}")
    header = await reader.readexactly(header_len)
    body = await reader.readexactly(body_len)
    return _checked_message(header, body, checksum)


def decode_buffer(buf: bytes) -> tuple[Optional[TwoPartMessage], bytes]:
    """Non-async incremental decode: returns (message | None, remaining)."""
    if len(buf) < PRELUDE_SIZE:
        return None, buf
    header_len, body_len, checksum = PRELUDE.unpack(buf[:PRELUDE_SIZE])
    if header_len + body_len > MAX_MESSAGE:
        raise CodecError(f"message too large: {header_len + body_len}")
    total = PRELUDE_SIZE + header_len + body_len
    if len(buf) < total:
        return None, buf
    header = buf[PRELUDE_SIZE:PRELUDE_SIZE + header_len]
    body = buf[PRELUDE_SIZE + header_len:total]
    return _checked_message(header, body, checksum), buf[total:]
