"""Row blob: the single definition of "an entity's state" as bytes/leaves.

Counterpart of ``noahgameframe_tpu/persist/rowblob.py``, over the port's
``ClassState`` of tensors.  The byte format is the same, so a blob framed
by the JAX package unframes here and the other way round:

* :func:`frame_blob` / :func:`unframe_blob` wrap a payload in magic,
  version, length and CRC32, and reject a torn or corrupt one;
* :func:`class_row_leaf_items` is the generic walk over every per-row
  leaf of a class (the room blob of ``parallel/rooms.py`` packs through
  it), checked against ``ROW_LEAF_SPEC``; :func:`rebuild_class_state` is
  its inverse and :func:`row_nbytes` the bytes one row carries.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import struct as _struct
import zlib
from typing import Any, List, Tuple

from ..core.store import ClassState, RecordState, TimerState
from ..core.tree import flatten

# -- framed blob -------------------------------------------------------------

MAGIC = b"NFRB"
VERSION = 1
_HEADER = _struct.Struct("<4sBII")  # magic, version, payload_len, crc32
MAX_BLOB = 64 * 1024 * 1024  # fail closed before allocating on a bad length


class RowBlobError(Exception):
    """A framed row blob failed validation (torn, corrupt, wrong version)."""


def frame_blob(payload: bytes) -> bytes:
    """Wrap a payload in magic + version + length + CRC32."""
    return _HEADER.pack(MAGIC, VERSION, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def unframe_blob(blob: bytes, allow_legacy: bool = True) -> bytes:
    """Validate and strip the frame; raise :class:`RowBlobError`, fail closed.

    ``allow_legacy=True`` passes a blob that does not start with the magic
    through unchanged (its decoder rejects it on its own terms).  A blob
    that does claim the magic must validate completely: truncation, length
    overrun, CRC mismatch and unknown versions are all errors."""
    if not blob.startswith(MAGIC):
        if allow_legacy:
            return blob
        raise RowBlobError("missing row-blob magic")
    if len(blob) < _HEADER.size:
        raise RowBlobError("truncated row-blob header")
    _magic, version, length, crc = _HEADER.unpack_from(blob)
    if version != VERSION:
        raise RowBlobError(f"unknown row-blob version {version}")
    if length > MAX_BLOB:
        raise RowBlobError(f"row-blob length {length} exceeds cap")
    payload = blob[_HEADER.size:]
    if len(payload) != length:
        raise RowBlobError(
            f"row-blob torn: header says {length} bytes, got {len(payload)}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise RowBlobError("row-blob CRC mismatch")
    return payload


# -- the ClassState row-leaf walk -----------------------------------------------

# Every ClassState leaf path must match one of these patterns (the JAX
# package's nf-lint rule migrate-covers-store reads its own copy).
ROW_LEAF_SPEC = (
    "i32",
    "f32",
    "vec",
    "alive",
    "timers.next_fire",
    "timers.interval",
    "timers.remain",
    "timers.active",
    "records.*.i32",
    "records.*.f32",
    "records.*.vec",
    "records.*.used",
)

# Leaves waived from the walk, with a reason each.  The Verlet caches live
# in WorldState.aux, not ClassState, so nothing is waived.
MIGRATION_EXCLUDED: Tuple[str, ...] = ()


def _covered(path: str) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in ROW_LEAF_SPEC + MIGRATION_EXCLUDED)


def _walk_fields(obj: Any, prefix: str, out: List[Tuple[str, Any]]) -> None:
    for f in dataclasses.fields(type(obj)):
        val = getattr(obj, f.name)
        path = prefix + f.name
        if isinstance(val, (TimerState, RecordState)):
            _walk_fields(val, path + ".", out)
        elif isinstance(val, dict):
            for key in sorted(val):
                _walk_fields(val[key], f"{path}.{key}.", out)
        else:
            out.append((path, val))


def class_row_leaf_items(cs: ClassState) -> List[Tuple[str, Any]]:
    """Ordered ``(path, tensor)`` pairs for every per-row leaf of ``cs``.

    Raises rather than silently dropping entity data when the walk sees
    fewer leaves than the ClassState tree holds (a new bank), a path is not
    covered by ``ROW_LEAF_SPEC``, or a leaf's leading axis is not the class
    capacity."""
    items: List[Tuple[str, Any]] = []
    _walk_fields(cs, "", items)
    n_tree = len(flatten(cs)[0])
    if len(items) != n_tree:
        raise RowBlobError(
            f"row-leaf walk found {len(items)} leaves but the ClassState "
            f"tree has {n_tree}: a store bank is invisible to the walk")
    cap = cs.capacity
    for path, arr in items:
        if not _covered(path):
            raise RowBlobError(
                f"ClassState leaf {path!r} not covered by ROW_LEAF_SPEC: "
                "add it to the spec (or MIGRATION_EXCLUDED with a reason)")
        if arr.ndim < 1 or arr.shape[0] != cap:
            raise RowBlobError(
                f"ClassState leaf {path!r} shape {tuple(arr.shape)} has no "
                "capacity-leading axis; cannot pack rows")
    return items


def rebuild_class_state(cs: ClassState, leaves: List[Any]) -> ClassState:
    """Inverse of :func:`class_row_leaf_items`: reassemble a ClassState
    from replacement leaves in the same walk order."""
    it = iter(leaves)

    def rebuild(obj: Any) -> Any:
        kw = {}
        for f in dataclasses.fields(type(obj)):
            val = getattr(obj, f.name)
            if isinstance(val, (TimerState, RecordState)):
                kw[f.name] = rebuild(val)
            elif isinstance(val, dict):
                kw[f.name] = {k: rebuild(val[k]) for k in sorted(val)}
            else:
                kw[f.name] = next(it)
        return obj.replace(**kw)

    out = rebuild(cs)
    if next(it, None) is not None:
        raise RowBlobError("rebuild_class_state: more leaves than store fields")
    return out


def row_nbytes(cs: ClassState) -> int:
    """Bytes one row carries (all banks, records, timers, the alive bit)."""
    total = 0
    for _path, arr in class_row_leaf_items(cs):
        per_row = 1
        for d in arr.shape[1:]:
            per_row *= int(d)
        total += per_row * arr.element_size()
    return total
