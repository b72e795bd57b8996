"""Write-behind durable persistence: stream the diff spine to the store
without ever blocking the tick.

The reference dedicates a whole async role to exactly this —
NFCAsyMysqlModule pushes player saves onto an actor queue so MySQL
round-trips never stall the main loop.  Here the kernel already computes
exactly what changed per tick (the device diff masks the GameRole drains
for sync), so durability is a *tap* on that spine: the role snapshots
each dirty entity's Save-flagged pack (persist.codec) and hands
``{key: blob}`` to this pipeline; a background flusher owns every store
round-trip.  The compiled tick never waits on a socket.

Robustness model, in order of defense:

1. **Staging WAL** (:class:`StagingWAL`): every enqueued batch is
   appended to a CRC-framed on-disk log *before* it is eligible to
   flush, using the same framing discipline as ``replay/journal.py``
   (fixed ``>HII`` header, explicit length, CRC32 per record, fail
   closed on corruption).  A role killed mid-flush loses nothing that
   reached the WAL: the next pipeline over the same directory recovers
   every batch past the flushed watermark and replays it.  Appends are
   OS-flushed (cheap) per batch; ``fsync`` happens only at
   :meth:`WriteBehindPipeline.barrier`, which the GameRole calls at its
   checkpoint marks — so the newest durable ``(checkpoint, WAL
   suffix)`` pair on disk is always mutually recoverable, mirroring the
   journal's checkpoint protocol.
2. **Bounded queue → coalesce-only degradation**: the in-memory queue
   holds at most ``max_queue_batches`` batches.  When the store is down
   long enough to fill it, adjacent batches are *coalesced* (later
   write per key wins — exactly the semantics the store would observe
   anyway) instead of blocking the producer or growing without bound.
   The WAL keeps the full history regardless; only RAM is bounded.
3. **Retry with capped backoff**: the flusher retries a failing batch
   on a :class:`net.retry.RetryPolicy` schedule (deterministic jitter,
   capped), surfacing ``nf_persist_degraded`` while the store is
   unreachable.  Flush order is strictly batch-sequence order, and
   sequence numbers derive from tick watermarks + a monotonic counter —
   never a wall clock — so recovery flushes are byte-identical to the
   flushes a crash interrupted.
4. **Idempotence**: a batch may be flushed twice (crash between store
   write and WAL mark).  Entries are full-blob upserts keyed by entity
   key, so replaying a batch is a no-op for the store; a per-pipeline
   watermark key (``__wb__:<name>``) records the last applied
   ``seq:tick`` so operators (and tests) can observe exactly-once
   *effects* over at-least-once delivery.

Thread contract: ``enqueue``/``note_tick``/``barrier``/``pump``/
``pending``/``discard`` are pump-thread calls and never touch the
store; the flusher thread owns every backend call.  The nf-lint
``pump-surface`` and ``fsync-barrier`` rules (docs/LINT.md) enforce
both properties structurally.

A copy of ``noahgameframe_tpu/persist/writebehind.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import os
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Deque, Dict, List, Optional, Tuple

from ..net.retry import RetryPolicy

WAL_MAGIC = b"NFWAL01\n"
WAL_GLOB = "wal-*.nfw"
HEADER = struct.Struct(">HII")  # (rec_type, body_len, crc32) — journal twin
BATCH_HEAD = struct.Struct(">qqI")  # (tick, seq, n_entries)
MARK_BODY = struct.Struct(">qq")  # (seq, tick) flushed through
U32 = struct.Struct(">I")
OP_PUT, OP_DEL = 0, 1

WB_META = 1
WB_BATCH = 2
WB_MARK = 3
_KNOWN_RECS = (WB_META, WB_BATCH, WB_MARK)

# same ceiling as the journal: a length past this is corruption
MAX_RECORD_SIZE = 64 * 1024 * 1024


class WALError(Exception):
    """Raised on malformed WAL bytes that cannot be a crash artifact:
    CRC mismatch on a complete frame, unknown record type, impossible
    length, or a torn tail anywhere but the newest segment.  A torn
    tail of the newest segment IS the expected crash artifact and is
    truncated away instead (bounded by the barrier fsync discipline)."""


def _segment_name(index: int) -> str:
    return f"wal-{index:08d}.nfw"


def _segment_index(path: Path) -> int:
    return int(path.stem.split("-", 1)[1])


class _TornTail(Exception):
    """Internal scan signal: a record header/body runs past the end of
    the segment bytes — the expected crash artifact on the newest
    segment.  The owning reader truncates it; the read-side peer scan
    skips it."""

    def __init__(self, off: int, what: str) -> None:
        super().__init__(what)
        self.off = off
        self.what = what


def _iter_frames(data: bytes, name: str):
    """Yield ``(offset, rec_type, body)`` for every complete CRC-checked
    frame in one segment's bytes.  Raises :class:`_TornTail` when the
    tail is incomplete, and :class:`WALError` on anything that cannot be
    a crash artifact (bad magic, unknown record type, impossible length,
    CRC mismatch on a complete frame)."""
    if data[: len(WAL_MAGIC)] != WAL_MAGIC:
        raise WALError(f"{name}: bad segment magic")
    off = len(WAL_MAGIC)
    while off < len(data):
        if off + HEADER.size > len(data):
            raise _TornTail(off, "torn record header")
        rec_type, length, crc = HEADER.unpack_from(data, off)
        if rec_type not in _KNOWN_RECS:
            raise WALError(f"{name}@{off}: unknown record type {rec_type}")
        if length > MAX_RECORD_SIZE:
            raise WALError(f"{name}@{off}: record length {length} "
                           f"exceeds {MAX_RECORD_SIZE}")
        if off + HEADER.size + length > len(data):
            raise _TornTail(off, "torn record body")
        body = data[off + HEADER.size: off + HEADER.size + length]
        if zlib.crc32(body) != crc:
            # a complete frame with a bad CRC is bit damage, not a
            # crash artifact — fail closed like the journal reader
            raise WALError(f"{name}@{off}: CRC mismatch")
        yield off, rec_type, body
        off += HEADER.size + length


class PeerWALView:
    """Read-only recovery view over a (possibly dead) pipeline's WAL
    directory — what :func:`read_peer_wal` returns."""

    __slots__ = ("pending", "flushed_seq", "flushed_tick", "max_tick",
                 "pending_batches", "torn_tail_skipped")

    def __init__(self, pending: Dict[str, Optional[bytes]],
                 flushed_seq: int, flushed_tick: int, max_tick: int,
                 pending_batches: int, torn_tail_skipped: int) -> None:
        self.pending = pending
        self.flushed_seq = int(flushed_seq)
        self.flushed_tick = int(flushed_tick)
        self.max_tick = int(max_tick)
        self.pending_batches = int(pending_batches)
        self.torn_tail_skipped = int(torn_tail_skipped)


def read_peer_wal(wal_dir) -> PeerWALView:
    """Read-side recovery over a PEER's WAL directory.

    The world's failover driver reconstructs a dead game's player blobs
    from the newest durable (checkpoint, WAL suffix) pair without taking
    ownership of the directory.  Unlike :class:`StagingWAL` construction
    this NEVER mutates the directory: a torn tail on the newest segment
    is skipped in memory, not truncated in place — the owner may later
    be revived over the same directory and must find its crash artifact
    exactly where it left it.  Corruption anywhere else raises
    :class:`WALError`, same as the owning reader.

    ``pending`` holds the newest value per key across every batch past
    the flushed watermark, applied in seq order (tombstones stay as
    ``None`` entries so callers can distinguish "deleted after the last
    flush" from "never staged").  An empty/missing directory yields an
    empty view — the store is then the only durable source.
    """
    path = Path(wal_dir)
    by_seq: Dict[int, Batch] = {}
    flushed_seq = 0
    flushed_tick = 0
    torn_skipped = 0
    segments = (sorted(path.glob(WAL_GLOB), key=_segment_index)
                if path.is_dir() else [])
    for i, seg in enumerate(segments):
        newest = i == len(segments) - 1
        try:
            for _off, rec_type, body in _iter_frames(seg.read_bytes(),
                                                     seg.name):
                if rec_type == WB_BATCH:
                    b = decode_batch(body)
                    by_seq[b.seq] = b
                elif rec_type == WB_MARK:
                    seq, tick = MARK_BODY.unpack(body)
                    if seq > flushed_seq:
                        flushed_seq, flushed_tick = seq, tick
        except _TornTail as torn:
            if not newest:
                raise WALError(
                    f"{seg.name}@{torn.off}: {torn.what} in closed segment"
                ) from torn
            torn_skipped += 1
    pending: Dict[str, Optional[bytes]] = {}
    max_tick = flushed_tick
    pending_batches = 0
    for b in sorted(by_seq.values(), key=lambda b: b.seq):
        if b.seq <= flushed_seq:
            continue
        pending.update(b.entries)
        max_tick = max(max_tick, b.tick)
        pending_batches += 1
    return PeerWALView(pending, flushed_seq, flushed_tick, max_tick,
                       pending_batches, torn_skipped)


class Batch:
    """One tick-watermarked, key-coalesced unit of durability.

    ``entries`` maps entity key -> blob (upsert) or None (tombstone);
    later batches win per key, so merging two batches is a dict merge."""

    __slots__ = ("seq", "tick", "entries")

    def __init__(self, seq: int, tick: int,
                 entries: Dict[str, Optional[bytes]]) -> None:
        self.seq = int(seq)
        self.tick = int(tick)
        self.entries = entries

    def merge_older(self, older: "Batch") -> None:
        """Absorb an OLDER batch (this batch's entries win per key)."""
        merged = dict(older.entries)
        merged.update(self.entries)
        self.entries = merged


def encode_batch(batch: Batch) -> bytes:
    out = bytearray(BATCH_HEAD.pack(batch.tick, batch.seq,
                                    len(batch.entries)))
    for key, blob in batch.entries.items():
        kb = key.encode("utf-8")
        out += U32.pack(len(kb)) + kb
        if blob is None:
            out.append(OP_DEL)
        else:
            out.append(OP_PUT)
            out += U32.pack(len(blob)) + blob
    return bytes(out)


def decode_batch(body: bytes) -> Batch:
    if len(body) < BATCH_HEAD.size:
        raise WALError(f"batch record too short ({len(body)} bytes)")
    tick, seq, n = BATCH_HEAD.unpack_from(body)
    off = BATCH_HEAD.size
    entries: Dict[str, Optional[bytes]] = {}
    for _ in range(n):
        if off + U32.size > len(body):
            raise WALError("batch entry truncated (key length)")
        (klen,) = U32.unpack_from(body, off)
        off += U32.size
        if off + klen + 1 > len(body):
            raise WALError("batch entry truncated (key/op)")
        key = body[off: off + klen].decode("utf-8")
        off += klen
        op = body[off]
        off += 1
        if op == OP_DEL:
            entries[key] = None
        elif op == OP_PUT:
            if off + U32.size > len(body):
                raise WALError("batch entry truncated (value length)")
            (vlen,) = U32.unpack_from(body, off)
            off += U32.size
            if off + vlen > len(body):
                raise WALError("batch entry truncated (value)")
            entries[key] = body[off: off + vlen]
            off += vlen
        else:
            raise WALError(f"unknown batch entry op {op}")
    if off != len(body):
        raise WALError(f"batch record has {len(body) - off} trailing bytes")
    return Batch(seq, tick, entries)


class StagingWAL:
    """Segmented, CRC-framed staging log for queued-but-unflushed
    batches.  Single-writer (the pump thread); the flusher never
    touches it — flush completions come back through
    :meth:`WriteBehindPipeline.pump`, which appends the marks.

    Construction recovers the directory: every batch past the newest
    flush mark is returned in ``pending`` (sorted by seq), segment
    numbering resumes, and a torn tail on the newest segment is
    truncated in place (the crash artifact the barrier protocol
    bounds).  Corruption anywhere else raises :class:`WALError`."""

    def __init__(self, path, segment_bytes: int = 1 << 20) -> None:
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = max(4096, int(segment_bytes))
        self.bytes_total = 0
        self.batches_total = 0
        self.torn_tail_dropped = 0
        # closed segments: [(index, path, max_seq)] for pruning
        self._closed: List[Tuple[int, Path, int]] = []
        self._cur_max_seq = -1
        self.pending: List[Batch] = []
        self.flushed_seq = 0
        self.flushed_tick = 0
        self._recover()
        existing = sorted(self.path.glob(WAL_GLOB), key=_segment_index)
        self._seg_index = _segment_index(existing[-1]) if existing else 0
        self._file = None
        self._seg_size = 0
        self._open_segment()

    # ---------------------------------------------------------- recovery
    def _recover(self) -> None:
        by_seq: Dict[int, Batch] = {}
        segments = sorted(self.path.glob(WAL_GLOB), key=_segment_index)
        for i, seg in enumerate(segments):
            newest = i == len(segments) - 1
            max_seq = self._scan_segment(seg, newest, by_seq)
            self._closed.append((_segment_index(seg), seg, max_seq))
        self.pending = sorted(
            (b for b in by_seq.values() if b.seq > self.flushed_seq),
            key=lambda b: b.seq,
        )

    def _scan_segment(self, seg: Path, newest: bool,
                      by_seq: Dict[int, Batch]) -> int:
        max_seq = -1
        try:
            for _off, rec_type, body in _iter_frames(seg.read_bytes(),
                                                     seg.name):
                if rec_type == WB_BATCH:
                    b = decode_batch(body)
                    by_seq[b.seq] = b
                    max_seq = max(max_seq, b.seq)
                elif rec_type == WB_MARK:
                    seq, tick = MARK_BODY.unpack(body)
                    if seq > self.flushed_seq:
                        self.flushed_seq, self.flushed_tick = seq, tick
        except _TornTail as torn:
            self._torn(seg, newest, torn.off, torn.what)
        return max_seq

    def _torn(self, seg: Path, newest: bool, off: int, what: str) -> int:
        if not newest:
            # older segments were fsynced at rotation; a torn record
            # there is corruption, not a crash tail
            raise WALError(f"{seg.name}@{off}: {what} in closed segment")
        with open(seg, "r+b") as f:
            f.truncate(off)
        self.torn_tail_dropped += 1
        return off

    # ---------------------------------------------------------- segments
    def _open_segment(self) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self._closed.append((
                self._seg_index,
                self.path / _segment_name(self._seg_index),
                self._cur_max_seq,
            ))
        self._seg_index += 1
        self._cur_max_seq = -1
        self._file = open(self.path / _segment_name(self._seg_index), "wb")
        self._file.write(WAL_MAGIC)
        self._seg_size = len(WAL_MAGIC)
        self.bytes_total += len(WAL_MAGIC)

    def _append(self, rec_type: int, body: bytes) -> None:
        if self._file is None:
            raise WALError("staging WAL is closed")
        if len(body) > MAX_RECORD_SIZE:
            raise WALError(f"record body {len(body)} exceeds "
                           f"{MAX_RECORD_SIZE}")
        frame = HEADER.pack(rec_type, len(body), zlib.crc32(body)) + body
        self._file.write(frame)
        # OS-flush per record: an in-process role kill (the chaos-smoke
        # kill path) loses nothing; only a machine crash can cost the
        # suffix past the last barrier fsync
        self._file.flush()
        self._seg_size += len(frame)
        self.bytes_total += len(frame)
        if self._seg_size >= self.segment_bytes:
            self._open_segment()

    # ----------------------------------------------------------- records
    def append_batch(self, batch: Batch) -> None:
        self._cur_max_seq = max(self._cur_max_seq, batch.seq)
        self._append(WB_BATCH, encode_batch(batch))
        self.batches_total += 1

    def mark(self, seq: int, tick: int) -> None:
        """Record that everything through batch `seq` (watermark `tick`)
        reached the store."""
        self._append(WB_MARK, MARK_BODY.pack(int(seq), int(tick)))
        if seq > self.flushed_seq:
            self.flushed_seq, self.flushed_tick = int(seq), int(tick)

    def prune(self) -> int:
        """Unlink closed segments whose every batch is below the newest
        durable mark; returns how many were removed."""
        keep, removed = [], 0
        for index, path, max_seq in self._closed:
            if max_seq <= self.flushed_seq and path.exists():
                path.unlink()
                removed += 1
            else:
                keep.append((index, path, max_seq))
        self._closed = keep
        return removed

    def sync(self) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file is not None:
            self.sync()
            self._file.close()
            self._file = None


# --------------------------------------------------------------- backends
class StoreBackend:
    """What the flusher needs from a store: blob upsert/delete + ping."""

    def write(self, key: str, blob: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def ping(self) -> bool:
        return True

    def close(self) -> None:
        pass


class KVBackend(StoreBackend):
    """KVStore adapter (memory/file/RESP): key → blob, natural upsert."""

    def __init__(self, kv) -> None:
        self.kv = kv

    def write(self, key: str, blob: bytes) -> None:
        self.kv.set(key, blob)

    def delete(self, key: str) -> None:
        self.kv.delete(key)

    def ping(self) -> bool:
        fn = getattr(self.kv, "ping", None)
        return bool(fn()) if fn is not None else True


class SqlBackend(StoreBackend):
    """SqlModule/MysqlModule adapter: one all-strings row per key with
    the blob hex-encoded (the reference module's valueVec contract)."""

    def __init__(self, sql, table: str = "Player",
                 column: str = "blob") -> None:
        self.sql = sql
        self.table = table
        self.column = column

    def write(self, key: str, blob: bytes) -> None:
        if not self.sql.updata(self.table, key, [self.column], [blob.hex()]):
            raise IOError(f"sql updata refused key {key!r}")

    def delete(self, key: str) -> None:
        self.sql.delete(self.table, key)

    def ping(self) -> bool:
        fn = getattr(self.sql, "ping", None)
        return bool(fn()) if fn is not None else True


def as_backend(store) -> StoreBackend:
    """KVStore → KVBackend, SqlModule-shaped → SqlBackend, StoreBackend
    (or anything already exposing write/delete) passes through."""
    if isinstance(store, StoreBackend):
        return store
    if hasattr(store, "write") and hasattr(store, "delete"):
        return store  # duck-typed backend (FaultyStore wraps like this)
    if hasattr(store, "set") and hasattr(store, "get"):
        return KVBackend(store)
    if hasattr(store, "updata"):
        return SqlBackend(store)
    raise TypeError(f"no write-behind backend for {type(store).__name__}")


# --------------------------------------------------------------- pipeline
class WriteBehindPipeline:
    """Bounded-queue async persistence: WAL-staged batches drained to a
    store backend on a background thread with capped-backoff retries.

    Pump-thread surface (never touches the store):
      enqueue / enqueue_one / note_tick / barrier / pump / pending /
      discard / lag_ticks / queue_depth / degraded
    Flusher-thread surface: the backend calls, and nothing else.
    """

    def __init__(self, store, wal_dir, *, registry=None,
                 max_queue_batches: int = 64,
                 retry: Optional[RetryPolicy] = None,
                 name: str = "persist",
                 segment_bytes: int = 1 << 20) -> None:
        self.backend = as_backend(store)
        self.name = str(name)
        self.retry = retry if retry is not None else RetryPolicy(
            base=0.05, cap=2.0, seed=zlib.crc32(self.name.encode())
        )
        self.max_queue_batches = max(4, int(max_queue_batches))
        self.wal = StagingWAL(wal_dir, segment_bytes=segment_bytes)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: Deque[Batch] = collections.deque(self.wal.pending)
        self.wal.pending = []
        self._next_seq = max(
            [b.seq for b in self._queue] + [self.wal.flushed_seq]
        ) + 1
        self._now_tick = max(
            [b.tick for b in self._queue] + [self.wal.flushed_tick]
        )
        self._completed: List[Tuple[int, int]] = []
        self._store_failing = False
        self._overflowed = False
        self._stop = False
        # counters the test/smoke assertions read directly
        self.flushes_total = 0
        self.retries_total = 0
        self.entries_total = 0
        self.recovered_batches = len(self._queue)
        # thread hygiene evidence: every thread that ever called the
        # backend (the non-blocking-tick assertion reads this)
        self.store_threads: set = set()
        self._register_metrics(registry)
        self._thread = threading.Thread(
            target=self._run, name=f"writebehind-{self.name}", daemon=True
        )
        self._thread.start()

    # -------------------------------------------------------- telemetry
    def _register_metrics(self, registry) -> None:
        if registry is None:
            self._flush_counter = self._retry_counter = None
            return
        self._flush_counter = registry.counter(
            "nf_persist_flush_total", "write-behind batches flushed"
        )
        self._retry_counter = registry.counter(
            "nf_persist_retry_total", "write-behind flush retries"
        )
        registry.gauge(
            "nf_persist_lag_ticks",
            "ticks since the oldest unflushed write-behind batch",
        ).set_function(self.lag_ticks)
        registry.gauge(
            "nf_persist_queue_depth", "write-behind batches queued in RAM"
        ).set_function(self.queue_depth)
        registry.gauge(
            "nf_persist_degraded",
            "1 while the store is unreachable or the queue overflowed",
        ).set_function(lambda: 1.0 if self.degraded() else 0.0)

    # ------------------------------------------------- pump-thread calls
    def enqueue(self, tick: int, items: Dict[str, Optional[bytes]]) -> int:
        """Stage one tick's coalesced dirty set.  Returns the batch seq
        (0 when `items` is empty).  Never blocks on the store."""
        if not items:
            return 0
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            batch = Batch(seq, tick, dict(items))
            self.wal.append_batch(batch)
            if len(self._queue) >= self.max_queue_batches:
                # coalesce-only degradation: merge the two oldest
                # *idle* batches (index 0 may be in flight) — RAM stays
                # bounded, the WAL keeps full history, later writes win
                if len(self._queue) >= 3:
                    older = self._queue[1]
                    newer = self._queue[2]
                    newer.merge_older(older)
                    del self._queue[1]
                self._overflowed = True
            self._queue.append(batch)
            self._now_tick = max(self._now_tick, int(tick))
            self._cond.notify_all()
            return seq

    def enqueue_one(self, key: str, blob: Optional[bytes]) -> int:
        """Single-entity staging at the current tick watermark (the
        agent's save-on-destroy path)."""
        return self.enqueue(self._now_tick, {key: blob})

    def note_tick(self, tick: int) -> None:
        """Advance the watermark clock (drives the lag gauge)."""
        with self._lock:
            self._now_tick = max(self._now_tick, int(tick))

    def barrier(self, tick: int) -> None:
        """Durability point: fsync the WAL so the (checkpoint at `tick`,
        WAL suffix) pair on disk is mutually recoverable.  Called from
        GameRole.checkpoint_now, next to the journal's checkpoint_mark."""
        with self._lock:
            self._now_tick = max(self._now_tick, int(tick))
            self.wal.sync()

    def pump(self) -> None:
        """Per-frame housekeeping on the pump thread: append flush
        marks for completed batches, prune dead WAL segments, clear the
        overflow latch once the queue drains."""
        with self._lock:
            done, self._completed = self._completed, []
            for seq, tick in done:
                self.wal.mark(seq, tick)
            if done:
                self.wal.prune()
            if self._overflowed and len(self._queue) <= self.max_queue_batches // 2:
                self._overflowed = False

    def pending(self, key: str) -> Tuple[bool, Optional[bytes]]:
        """Read-your-writes: newest queued value for `key`.  Returns
        (found, blob); blob None means a queued tombstone."""
        with self._lock:
            for batch in reversed(self._queue):
                if key in batch.entries:
                    return True, batch.entries[key]
        return False, None

    def discard(self, key: str) -> int:
        """Drop every queued value for `key` (role deletion must not be
        resurrected by an older queued save).  The WAL copy is
        superseded by enqueueing a tombstone instead — use
        ``enqueue_one(key, None)`` for durable deletes."""
        n = 0
        with self._lock:
            for batch in self._queue:
                if key in batch.entries:
                    del batch.entries[key]
                    n += 1
        return n

    # ----------------------------------------------------------- gauges
    def lag_ticks(self) -> int:
        with self._lock:
            if not self._queue:
                return 0
            return max(0, self._now_tick - self._queue[0].tick)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def degraded(self) -> bool:
        return self._store_failing or self._overflowed

    # --------------------------------------------------------- shutdown
    def drain(self, timeout: float = 2.0) -> bool:
        """Best-effort flush of everything queued; True when the queue
        emptied.  On timeout (store down) the batches stay durable in
        the WAL for the next pipeline over this directory."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        while time.monotonic() < deadline:
            self.pump()
            with self._lock:
                if not self._queue:
                    break
            time.sleep(0.01)
        self.pump()
        with self._lock:
            drained = not self._queue
            self.wal.sync()
        return drained

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        with self._lock:
            self.wal.close()

    def kill(self) -> None:
        """Test-only abrupt stop: no drain, no final mark — simulates a
        role killed mid-flush (WAL appends are already OS-flushed)."""
        with self._lock:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        with self._lock:
            if self.wal._file is not None:
                self.wal._file.close()
                self.wal._file = None

    # --------------------------------------------------- flusher thread
    def _run(self) -> None:
        attempt = 0
        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
                batch = self._queue[0]  # peek; pop only after success
            try:
                self._flush_batch(batch)
            except Exception:  # noqa: BLE001 — any store error = retry
                attempt += 1
                self.retries_total += 1
                self._store_failing = True
                if self._retry_counter is not None:
                    self._retry_counter.inc()
                delay = self.retry.delay(attempt, key=self.name)
                with self._lock:
                    if self._stop:
                        return
                    self._cond.wait(timeout=delay)
                continue
            attempt = 0
            self._store_failing = False
            self.flushes_total += 1
            self.entries_total += len(batch.entries)
            if self._flush_counter is not None:
                self._flush_counter.inc()
            with self._lock:
                if self._queue and self._queue[0] is batch:
                    self._queue.popleft()
                self._completed.append((batch.seq, batch.tick))

    def _flush_batch(self, batch: Batch) -> None:
        self.store_threads.add(threading.get_ident())
        for key, blob in batch.entries.items():
            if blob is None:
                self.backend.delete(key)
            else:
                self.backend.write(key, blob)
        # idempotence watermark: replays of this batch are observable as
        # a non-advancing seq (entries themselves are natural upserts)
        self.backend.write(
            f"__wb__:{self.name}",
            f"{batch.seq}:{batch.tick}".encode(),
        )
