"""Frame codec: the 6-byte NF wire header, byte-compatible with the
reference protocol (`NFComm/NFNet/NFINet.h:168-233` — header =
big-endian u16 msgID + u32 total packet size *including* the header).

The decoder is incremental: feed arbitrary byte chunks, get complete
(msg_id, body) frames out.  This is the single framing implementation
used by both the pure-Python transport and the role processes; the
native C++ transport implements the identical layout in
``native/nfnet.cc``.

A copy of ``noahgameframe_tpu/net/framing.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

HEAD_LENGTH = 6
_HEAD = struct.Struct(">HI")  # msg_id, total_size (body + header)

#: Hard upper bound on a single frame, mirroring sane server limits; a
#: peer announcing more than this is treated as a protocol violation.
MAX_FRAME_SIZE = 64 * 1024 * 1024


class ProtocolError(Exception):
    """Peer sent bytes that cannot be a valid NF frame."""


def pack_frame(msg_id: int, body: bytes) -> bytes:
    """Encode one frame: header(msgID, len(body)+6) + body."""
    return _HEAD.pack(msg_id, len(body) + HEAD_LENGTH) + body


def unpack_head(data: bytes) -> Tuple[int, int]:
    """Decode a 6-byte header -> (msg_id, body_length)."""
    msg_id, total = _HEAD.unpack_from(data)
    return msg_id, total - HEAD_LENGTH


class FrameDecoder:
    """Incremental frame reassembly over a byte stream.

    Mirrors the reference's `Dismantle` loop (`NFCNet.cpp:110-160`):
    buffer until a full header + body is available, emit, repeat.
    """

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[int, bytes]] = []
        buf = self._buf
        off = 0
        while len(buf) - off >= HEAD_LENGTH:
            msg_id, total = _HEAD.unpack_from(buf, off)
            if total < HEAD_LENGTH or total > MAX_FRAME_SIZE:
                raise ProtocolError(f"bad frame size {total} (msg_id={msg_id})")
            if len(buf) - off < total:
                break
            body = bytes(buf[off + HEAD_LENGTH : off + total])
            out.append((msg_id, body))
            off += total
        if off:
            del buf[:off]
        return out

    def pending(self) -> int:
        return len(self._buf)


def iter_frames(blob: bytes) -> Iterator[Tuple[int, bytes]]:
    """Decode a complete byte blob containing whole frames."""
    dec = FrameDecoder()
    yield from dec.feed(blob)
    if dec.pending():
        raise ProtocolError(f"{dec.pending()} trailing bytes after last frame")
