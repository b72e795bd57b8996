"""Append-only, segmented, CRC-framed tick journal.

Framing follows the wire discipline of :mod:`net.framing` — a fixed
header carrying an id and an explicit length, decoded incrementally with
hard bounds — plus a CRC32 per record, because unlike a TCP stream a
file on disk CAN be torn or bit-flipped and the reader must fail closed
(`test_wire_fuzz.py` covers the stream case; `tests/test_replay.py`
fuzzes this one).

Layout of a journal directory::

    journal.json            run metadata (world seed, dt, writer info)
    seg-00000001.nfj        segment: 8-byte magic, then records
    seg-00000002.nfj        ...rotated by size at record boundaries

Record frame (header ``>HII`` = 10 bytes, big-endian like the wire)::

    +---------+-----------+-----------+----------------+
    | type u16| length u32| crc32 u32 | body (length)  |
    +---------+-----------+-----------+----------------+

Record types:

- ``REC_META``  — JSON; one per segment head (self-describing segments)
- ``REC_EVENT`` — one dispatched net event (``>Bqii`` source/conn/kind/
  msg_id + raw body bytes), in exact dispatch order
- ``REC_TICK``  — ``>qI`` kernel tick count + uint32 on-device state
  digest, written after every completed tick
- ``REC_NOTE``  — JSON epoch markers (chaos seed + link budgets, config
  changes, resumes)
- ``REC_CKPT``  — ``>q`` tick at which an atomic checkpoint landed; the
  writer fsyncs here so the ``(checkpoint, journal-suffix)`` pair on
  disk is always mutually recoverable

The writer rotates segments by size and fsyncs the old segment before
opening the next, so only the very tail of the newest segment is ever
at risk from a crash — exactly the suffix the checkpoint protocol
already bounds.

A copy of ``noahgameframe_tpu/replay/journal.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

SEGMENT_MAGIC = b"NFJSEG1\n"
SEGMENT_GLOB = "seg-*.nfj"
HEADER = struct.Struct(">HII")  # (rec_type, body_len, crc32)
EVENT_HEAD = struct.Struct(">Bqii")  # (source, conn_id, kind, msg_id)
TICK_BODY = struct.Struct(">qI")  # (tick, digest)
CKPT_BODY = struct.Struct(">q")  # (tick,)

REC_META = 1
REC_EVENT = 2
REC_TICK = 3
REC_NOTE = 4
REC_CKPT = 5
_KNOWN_RECS = (REC_META, REC_EVENT, REC_TICK, REC_NOTE, REC_CKPT)

# which endpoint dispatched a journaled event
SRC_SERVER = 0  # the role's listening NetServerModule (client/proxy side)
SRC_WORLD = 1  # the world-link NetClientModule (world commands, switches)

# same ceiling as net.framing.MAX_FRAME_SIZE: a length field pointing
# past it is corruption, not a big record
MAX_RECORD_SIZE = 64 * 1024 * 1024


class JournalError(Exception):
    """Raised on any malformed journal byte — torn tail, bad magic, CRC
    mismatch, impossible length, unknown record type.  Replay must never
    silently skip input."""


def _segment_name(index: int) -> str:
    return f"seg-{index:08d}.nfj"


def _segment_index(path: Path) -> int:
    return int(path.stem.split("-", 1)[1])


class JournalWriter:
    """Appender for one recording run.  Single-owner, pump-thread only
    (the roles are single-threaded); durability points are explicit via
    :meth:`sync`, which :meth:`GameRole.checkpoint_now` calls."""

    def __init__(self, path, meta: Optional[dict] = None,
                 segment_bytes: int = 1 << 20) -> None:
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = max(4096, int(segment_bytes))
        existing = sorted(self.path.glob(SEGMENT_GLOB))
        self._seg_index = (_segment_index(existing[-1]) if existing else 0)
        self._file = None
        self._seg_size = 0
        # telemetry feed (nf_journal_*_total): monotonic over the writer
        self.bytes_total = 0
        self.segments_total = 0
        self.ticks_total = 0
        self.last_tick = -1
        self.meta = dict(meta or {})
        (self.path / "journal.json").write_text(
            json.dumps({"version": 1, "meta": self.meta})
        )
        self._open_segment()

    # ------------------------------------------------------------ segments
    def _open_segment(self) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
        self._seg_index += 1
        self._file = open(self.path / _segment_name(self._seg_index), "wb")
        self._file.write(SEGMENT_MAGIC)
        self._seg_size = len(SEGMENT_MAGIC)
        self.bytes_total += len(SEGMENT_MAGIC)
        self.segments_total += 1
        self._append(REC_META, json.dumps(
            {"segment": self._seg_index, "after_tick": self.last_tick}
        ).encode())
        # push the header past the userspace buffer right away: open()
        # already created the file, so without this a concurrent reader
        # (live digest checks, the failover smoke) sees an EMPTY segment
        # and calls it corrupt — fail-closed readers need the magic on
        # disk the moment the segment is observable
        self._file.flush()

    def _append(self, rec_type: int, body: bytes) -> None:
        if self._file is None:
            raise JournalError("journal writer is closed")
        if len(body) > MAX_RECORD_SIZE:
            raise JournalError(
                f"record body {len(body)} exceeds {MAX_RECORD_SIZE}"
            )
        frame = HEADER.pack(rec_type, len(body), zlib.crc32(body)) + body
        self._file.write(frame)
        self._seg_size += len(frame)
        self.bytes_total += len(frame)

    # ------------------------------------------------------------- records
    def event(self, source: int, kind: int, conn_id: int, msg_id: int,
              body: bytes) -> None:
        """One dispatched net event, in dispatch order (the host→device
        boundary: every world mutation between two ticks comes from
        these)."""
        self._append(
            REC_EVENT,
            EVENT_HEAD.pack(int(source), int(conn_id), int(kind),
                            int(msg_id)) + bytes(body),
        )

    def tick_mark(self, tick: int, digest: int) -> None:
        """Close the tick window: everything journaled since the last
        mark fed THIS tick, whose post-state hashes to `digest`.
        Rotation happens here — between ticks — so one tick's input
        window never straddles a segment boundary mid-event."""
        self._append(REC_TICK, TICK_BODY.pack(int(tick),
                                              int(digest) & 0xFFFFFFFF))
        self.ticks_total += 1
        self.last_tick = int(tick)
        if self._seg_size >= self.segment_bytes:
            self._open_segment()

    def note(self, info: dict) -> None:
        """Epoch marker (chaos seed + budgets, config flips, resume)."""
        self._append(REC_NOTE, json.dumps(info, default=str).encode())

    def checkpoint_mark(self, tick: int) -> None:
        """Record that an atomic checkpoint landed after `tick`, then
        make everything up to here durable — the journal suffix past the
        newest mark is exactly what replay needs on top of that
        checkpoint."""
        self._append(REC_CKPT, CKPT_BODY.pack(int(tick)))
        self.sync()

    def sync(self) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file is not None:
            self.sync()
            self._file.close()
            self._file = None


class JournalReader:
    """Strict, ordered reader over every segment of a journal directory.
    Any framing violation raises :class:`JournalError` with the segment
    and byte offset — fail closed, never guess."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        if not self.path.is_dir():
            raise JournalError(f"no journal directory at {self.path}")
        self.segments = sorted(self.path.glob(SEGMENT_GLOB),
                               key=_segment_index)
        if not self.segments:
            raise JournalError(f"no segments in {self.path}")
        meta_path = self.path / "journal.json"
        self.meta: dict = {}
        if meta_path.exists():
            try:
                self.meta = json.loads(meta_path.read_text()).get("meta", {})
            except ValueError as e:
                raise JournalError(f"corrupt journal.json: {e}") from e

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        for seg in self.segments:
            yield from self._iter_segment(seg)

    def _iter_segment(self, seg: Path) -> Iterator[Tuple[int, bytes]]:
        data = seg.read_bytes()
        if data[: len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
            raise JournalError(f"{seg.name}: bad segment magic")
        off = len(SEGMENT_MAGIC)
        while off < len(data):
            if off + HEADER.size > len(data):
                raise JournalError(
                    f"{seg.name}@{off}: torn record header "
                    f"({len(data) - off} of {HEADER.size} bytes)"
                )
            rec_type, length, crc = HEADER.unpack_from(data, off)
            if rec_type not in _KNOWN_RECS:
                raise JournalError(
                    f"{seg.name}@{off}: unknown record type {rec_type}"
                )
            if length > MAX_RECORD_SIZE:
                raise JournalError(
                    f"{seg.name}@{off}: record length {length} exceeds "
                    f"{MAX_RECORD_SIZE}"
                )
            off += HEADER.size
            if off + length > len(data):
                raise JournalError(
                    f"{seg.name}@{off}: torn record body "
                    f"({len(data) - off} of {length} bytes)"
                )
            body = data[off: off + length]
            if zlib.crc32(body) != crc:
                raise JournalError(f"{seg.name}@{off}: CRC mismatch")
            off += length
            yield rec_type, body


# --------------------------------------------------------------- decoding
def decode_event(body: bytes) -> Tuple[int, int, int, int, bytes]:
    """-> (source, conn_id, kind, msg_id, payload)."""
    if len(body) < EVENT_HEAD.size:
        raise JournalError(f"event record too short ({len(body)} bytes)")
    source, conn_id, kind, msg_id = EVENT_HEAD.unpack_from(body)
    return source, conn_id, kind, msg_id, body[EVENT_HEAD.size:]


def decode_tick(body: bytes) -> Tuple[int, int]:
    """-> (tick, digest)."""
    if len(body) != TICK_BODY.size:
        raise JournalError(f"tick record wrong size ({len(body)} bytes)")
    return TICK_BODY.unpack(body)


def decode_ckpt(body: bytes) -> int:
    if len(body) != CKPT_BODY.size:
        raise JournalError(f"ckpt record wrong size ({len(body)} bytes)")
    return CKPT_BODY.unpack(body)[0]


def decode_json(body: bytes) -> dict:
    try:
        return json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise JournalError(f"corrupt JSON record: {e}") from e


def read_ticks(path) -> Dict[int, int]:
    """The digest stream: tick -> uint32 digest, every tick on record.
    This is all bisect needs from a run."""
    out: Dict[int, int] = {}
    for rec_type, body in JournalReader(path):
        if rec_type == REC_TICK:
            tick, digest = decode_tick(body)
            out[tick] = digest
    return out
