"""The port's row blob codec (noahgameframe_tpu_torch.persist.rowblob)
after tests/test_rowblob.py, case for case: the CRC frame the failover
hand-off rides (truncation, bit flips, bad magic, oversize lengths all
fail closed), and the ClassState leaf walk the migration packs rows
with (coverage of the state's leaves by the port's own tree walk,
rebuild round trip, per-row byte accounting)."""

import random
import struct

import numpy as np
import pytest
import torch

from noahgameframe_tpu_torch.core import tree
from noahgameframe_tpu_torch.core.schema import ClassDef, ClassRegistry, prop, record
from noahgameframe_tpu_torch.core.store import EntityStore, StoreConfig
from noahgameframe_tpu_torch.persist.rowblob import (
    MAGIC,
    MIGRATION_EXCLUDED,
    ROW_LEAF_SPEC,
    RowBlobError,
    class_row_leaf_items,
    frame_blob,
    rebuild_class_state,
    row_nbytes,
    unframe_blob,
)
from test_torch_parity import one_intra_op_thread  # noqa: F401


# ----------------------------------------------------------------- framing
class TestFrame:
    def test_round_trip(self):
        payload = b"entity state bytes \x00\x01\xff" * 9
        assert unframe_blob(frame_blob(payload)) == payload

    def test_empty_payload_round_trips(self):
        assert unframe_blob(frame_blob(b"")) == b""

    def test_legacy_passthrough_without_magic(self):
        # pre-framing peers (and raw garbage) flow through unchanged —
        # the snapshot codec downstream rejects them on its own terms
        raw = b"\xff\xfe\xfd not a snapshot \x00\x01"
        assert unframe_blob(raw) == raw

    def test_legacy_refused_when_disallowed(self):
        with pytest.raises(RowBlobError, match="magic"):
            unframe_blob(b"legacy", allow_legacy=False)

    def test_truncated_tail_mid_body(self):
        blob = frame_blob(b"x" * 64)
        for cut in (len(blob) - 1, len(blob) - 17, 14):
            with pytest.raises(RowBlobError):
                unframe_blob(blob[:cut])

    def test_truncated_mid_header(self):
        blob = frame_blob(b"payload")
        with pytest.raises(RowBlobError):
            unframe_blob(blob[:7])

    def test_bit_flips_fail_crc(self):
        payload = bytes(range(256)) * 4
        blob = frame_blob(payload)
        rng = random.Random(5)
        for _ in range(32):
            i = rng.randrange(13, len(blob))  # body bytes, not the magic
            torn = bytearray(blob)
            torn[i] ^= 1 << rng.randrange(8)
            with pytest.raises(RowBlobError):
                unframe_blob(bytes(torn))

    def test_unknown_version_is_refused(self):
        blob = bytearray(frame_blob(b"abc"))
        blob[4] = 99  # version byte
        with pytest.raises(RowBlobError, match="version"):
            unframe_blob(bytes(blob))

    def test_oversize_length_is_corruption_not_allocation(self):
        hdr = struct.pack("<4sBII", MAGIC, 1, 1 << 31, 0)
        with pytest.raises(RowBlobError):
            unframe_blob(hdr + b"tiny")

    def test_length_overrun_is_torn(self):
        blob = frame_blob(b"abcdef")
        with pytest.raises(RowBlobError, match="torn"):
            unframe_blob(blob + b"trailing junk")


# --------------------------------------------------------------- leaf walk
def _full_store_class():
    reg = ClassRegistry()
    reg.define(ClassDef(name="Npc", properties=[
        prop("HP", "int"), prop("Speed", "float"),
        prop("Position", "vector3"),
    ], records=[
        record("Bag", 4, [("item", "int"), ("weight", "float")]),
        record("Buffs", 2, [("vec", "vector3")]),
    ]))
    store = EntityStore(reg, StoreConfig(
        default_capacity=16, capacities={"Npc": 16},
        timer_slots={"Npc": 2},
    ), device="cpu")
    return store.init_state(seed=0).classes["Npc"]


class TestLeafWalk:
    def test_covers_every_pytree_leaf(self):
        cs = _full_store_class()
        items = class_row_leaf_items(cs)
        # the port's own leaf walk over the same ClassState
        assert len(items) == len(tree.flatten(cs)[0])
        paths = [p for p, _ in items]
        # property banks, alive, all four timer leaves, both records
        assert {"i32", "f32", "vec", "alive"} <= set(paths)
        assert sum(p.startswith("timers.") for p in paths) == 4
        assert sum(p.startswith("records.Bag.") for p in paths) == 4
        assert sum(p.startswith("records.Buffs.") for p in paths) == 4

    def test_rebuild_round_trips(self):
        cs = _full_store_class()
        items = class_row_leaf_items(cs)
        bumped = [a + 1 if a.dtype != torch.bool else ~a for _, a in items]
        cs2 = rebuild_class_state(cs, bumped)
        for (path, old), new in zip(class_row_leaf_items(cs2), bumped):
            np.testing.assert_array_equal(np.asarray(old), np.asarray(new),
                                          err_msg=path)

    def test_rebuild_leaf_count_mismatch_raises(self):
        cs = _full_store_class()
        leaves = [a for _, a in class_row_leaf_items(cs)]
        with pytest.raises((RowBlobError, StopIteration)):
            rebuild_class_state(cs, leaves[:-1])

    def test_row_nbytes_counts_every_bank(self):
        cs = _full_store_class()
        expect = sum(
            int(np.prod(a.shape[1:], dtype=np.int64)) * a.element_size()
            if a.ndim > 1 else a.element_size()
            for _, a in class_row_leaf_items(cs)
        )
        assert row_nbytes(cs) == expect > 0

    def test_spec_patterns_are_exhaustive_and_fresh(self):
        # the static contract the migrate-covers-store lint rule pins:
        # every walked path matches the spec, and every non-wildcard
        # spec entry corresponds to a real store field
        import fnmatch

        cs = _full_store_class()
        paths = [p for p, _ in class_row_leaf_items(cs)]
        for p in paths:
            assert any(fnmatch.fnmatch(p, pat)
                       for pat in ROW_LEAF_SPEC + MIGRATION_EXCLUDED), p
        for pat in ROW_LEAF_SPEC:
            assert any(fnmatch.fnmatch(p, pat) for p in paths), pat
