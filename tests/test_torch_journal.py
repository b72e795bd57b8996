"""The port's journal and bisect (noahgameframe_tpu_torch/replay/) against
the JAX package on the CPU: the same run journaled by each package gives
byte-identical segment files, each package reads the other's, the port's
reader fails closed on torn or flipped bytes (the reference's fuzz cases),
and bisect_divergence / field_diff over a port run perturbed at one tick
name that tick and that leaf."""

import zlib

import pytest

from noahgameframe_tpu.game.world import GameWorld as JWorld
from noahgameframe_tpu.game.world import WorldConfig as JConfig
from noahgameframe_tpu.replay.journal import JournalReader as JReader
from noahgameframe_tpu.replay.journal import JournalWriter as JWriter
from noahgameframe_tpu.replay.journal import read_ticks as jread_ticks
from noahgameframe_tpu_torch.core.store import with_class
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
from noahgameframe_tpu_torch.replay import (
    JournalError,
    JournalReader,
    JournalWriter,
    bisect_divergence,
    field_diff,
    first_divergence_linear,
    read_ticks,
)
from noahgameframe_tpu_torch.replay.journal import (
    HEADER,
    MAX_RECORD_SIZE,
    REC_CKPT,
    REC_EVENT,
    REC_META,
    REC_NOTE,
    REC_TICK,
    SEGMENT_MAGIC,
    SRC_SERVER,
    SRC_WORLD,
    decode_ckpt,
    decode_event,
    decode_json,
    decode_tick,
)
from test_torch_parity import one_intra_op_thread  # noqa: F401


def _world(jax_side: bool):
    """A small combat world with the digest on, in either package."""
    if jax_side:
        w = JWorld(JConfig(npc_capacity=128, player_capacity=8, extent=32.0, seed=4,
                           middleware=False)).start()
    else:
        w = GameWorld(WorldConfig(npc_capacity=128, player_capacity=8, extent=32.0, seed=4,
                                  middleware=False), device="cpu").start()
    w.kernel.store.guids.pin(300)
    w.scene.create_scene(1, width=32.0)
    w.seed_npcs(100)
    w.kernel.enable_digest()
    return w


def _journal_run(w, writer, ticks: int):
    """Tick ``w``, journaling a note, two events a tick and each tick's
    digest, with a checkpoint mark halfway."""
    writer.note({"kind": "run", "seed": 4})
    for t in range(1, ticks + 1):
        writer.event(SRC_SERVER, 3, t, 100 + t, bytes(range(t % 40)) * 5)
        writer.event(SRC_WORLD, 1, -1, 7, b"w")
        w.tick()
        writer.tick_mark(w.kernel.tick_count, w.kernel.last_counters["state_digest"])
        if t == ticks // 2:
            writer.checkpoint_mark(t)
    writer.close()


def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def test_journals_of_one_run_byte_identical(tmp_path):
    """The same world run journaled by each package (segments rotated by
    size): identical files byte for byte, and each package's reader and
    read_ticks read the other's journal."""
    for name, jax_side, writer in (("jax", True, JWriter), ("port", False, JournalWriter)):
        w = _world(jax_side)
        _journal_run(w, writer(tmp_path / name, meta={"seed": 4}, segment_bytes=4096), 30)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert len([n for n in files if n.startswith("seg-")]) >= 2
    assert read_ticks(tmp_path / "jax") == jread_ticks(tmp_path / "port")
    assert len(read_ticks(tmp_path / "port")) == 30
    assert list(JournalReader(tmp_path / "jax")) == list(JReader(tmp_path / "port"))
    assert JournalReader(tmp_path / "jax").meta == {"seed": 4}


# ------------------------------------------------------------- journal codec
# (the reference's tests/test_replay.py codec and fuzz cases, against the
# port's writer and reader)
class TestJournalCodec:
    def test_round_trip_all_record_types(self, tmp_path):
        w = JournalWriter(tmp_path / "j", meta={"world_seed": 7})
        w.note({"kind": "chaos", "seed": 7})
        w.event(SRC_SERVER, 3, 42, 109, b"hello")
        w.event(SRC_WORLD, 3, -1, 210, b"")
        w.tick_mark(1, 0xDEADBEEF)
        w.checkpoint_mark(1)
        w.tick_mark(2, 2**31 + 5)  # digests are uint32: sign must not leak
        w.close()

        r = JournalReader(tmp_path / "j")
        assert r.meta == {"world_seed": 7}
        recs = list(r)
        kinds = [t for t, _ in recs]
        assert kinds == [REC_META, REC_NOTE, REC_EVENT, REC_EVENT,
                         REC_TICK, REC_CKPT, REC_TICK]
        assert decode_json(recs[1][1])["seed"] == 7
        assert decode_event(recs[2][1]) == (SRC_SERVER, 42, 3, 109, b"hello")
        assert decode_event(recs[3][1]) == (SRC_WORLD, -1, 3, 210, b"")
        assert decode_tick(recs[4][1]) == (1, 0xDEADBEEF)
        assert decode_ckpt(recs[5][1]) == 1
        assert decode_tick(recs[6][1]) == (2, (2**31 + 5) & 0xFFFFFFFF)
        assert read_ticks(tmp_path / "j") == {
            1: 0xDEADBEEF, 2: (2**31 + 5) & 0xFFFFFFFF
        }

    def test_rotation_at_tick_boundaries_only(self, tmp_path):
        w = JournalWriter(tmp_path / "j", segment_bytes=4096)
        body = bytes(300)
        for t in range(1, 31):
            # a fat event window, then the tick mark that may rotate
            for _ in range(3):
                w.event(SRC_SERVER, 3, 1, 7, body)
            w.tick_mark(t, t * 17)
        w.close()
        segs = sorted((tmp_path / "j").glob("seg-*.nfj"))
        assert len(segs) >= 2, "rotation never happened"
        assert w.segments_total == len(segs)
        assert w.ticks_total == 30
        # order survives the segment boundary, and every segment head
        # carries its self-describing META record
        ticks, metas = [], 0
        for rec_type, rec in JournalReader(tmp_path / "j"):
            if rec_type == REC_TICK:
                ticks.append(decode_tick(rec)[0])
            elif rec_type == REC_META:
                metas += 1
        assert ticks == list(range(1, 31))
        assert metas == len(segs)
        # rotation happens only right after a tick mark: every segment
        # except the newest ENDS with a complete REC_TICK frame
        for seg in segs[:-1]:
            last = None
            data = seg.read_bytes()
            off = len(SEGMENT_MAGIC)
            while off < len(data):
                rec_type, length, _ = HEADER.unpack_from(data, off)
                off += HEADER.size + length
                last = rec_type
            assert last == REC_TICK

    def test_writer_resumes_segment_numbering(self, tmp_path):
        w = JournalWriter(tmp_path / "j")
        w.tick_mark(1, 1)
        w.close()
        w2 = JournalWriter(tmp_path / "j")
        w2.tick_mark(2, 2)
        w2.close()
        # a second recording run must never clobber existing segments
        segs = sorted((tmp_path / "j").glob("seg-*.nfj"))
        assert len(segs) == 2
        assert read_ticks(tmp_path / "j") == {1: 1, 2: 2}


# ---------------------------------------------------------------- fuzz
# the on-disk sibling of test_wire_fuzz's framing section: a journal can
# be torn or bit-flipped at rest, and the reader must fail closed with
# JournalError — never crash, never silently skip input.
class TestJournalFuzz:
    @pytest.fixture()
    def journal(self, tmp_path):
        w = JournalWriter(tmp_path / "j", meta={"s": 1})
        for t in range(1, 9):
            w.event(SRC_SERVER, 3, 5, 11, bytes(range(64)))
            w.tick_mark(t, t * 31)
        w.close()
        return tmp_path / "j"

    @staticmethod
    def _seg(journal):
        return sorted(journal.glob("seg-*.nfj"))[0]

    @staticmethod
    def _assert_fails_closed(journal):
        with pytest.raises(JournalError):
            for _ in JournalReader(journal):
                pass

    def test_clean_journal_reads(self, journal):
        assert len(read_ticks(journal)) == 8

    def test_truncated_tail_mid_body(self, journal):
        seg = self._seg(journal)
        seg.write_bytes(seg.read_bytes()[:-7])
        self._assert_fails_closed(journal)

    def test_truncated_tail_mid_header(self, journal):
        seg = self._seg(journal)
        data = seg.read_bytes()
        seg.write_bytes(data + HEADER.pack(REC_TICK, 12, 0)[:5])
        self._assert_fails_closed(journal)

    def test_bit_flips_in_bodies_fail_crc(self, journal):
        import random

        seg = self._seg(journal)
        clean = seg.read_bytes()
        # locate every body byte by walking the valid frames, then flip
        # a sample of them: CRC32 must catch each one
        body_spans = []
        off = len(SEGMENT_MAGIC)
        while off < len(clean):
            _, length, _ = HEADER.unpack_from(clean, off)
            off += HEADER.size
            if length:
                body_spans.append((off, off + length))
            off += length
        rng = random.Random(5)
        flips = [rng.randrange(a, b) for a, b in body_spans for _ in (0,)]
        for pos in flips[:16]:
            mutated = bytearray(clean)
            mutated[pos] ^= 1 << rng.randrange(8)
            seg.write_bytes(bytes(mutated))
            self._assert_fails_closed(journal)
        seg.write_bytes(clean)

    def test_torn_mid_segment(self, journal):
        seg = self._seg(journal)
        data = seg.read_bytes()
        # cut inside the third record's body, keep a later-looking tail
        seg.write_bytes(data[: len(data) // 2 - 3])
        self._assert_fails_closed(journal)

    def test_bad_magic(self, journal):
        seg = self._seg(journal)
        data = bytearray(seg.read_bytes())
        data[0] ^= 0xFF
        seg.write_bytes(bytes(data))
        self._assert_fails_closed(journal)

    def test_unknown_record_type(self, journal):
        seg = self._seg(journal)
        seg.write_bytes(seg.read_bytes()
                        + HEADER.pack(99, 0, zlib.crc32(b"")))
        self._assert_fails_closed(journal)

    def test_oversize_length_is_corruption_not_allocation(self, journal):
        seg = self._seg(journal)
        seg.write_bytes(seg.read_bytes()
                        + HEADER.pack(REC_NOTE, MAX_RECORD_SIZE + 1, 0))
        self._assert_fails_closed(journal)

    def test_empty_directory_fails_closed(self, tmp_path):
        (tmp_path / "empty").mkdir()
        with pytest.raises(JournalError):
            JournalReader(tmp_path / "empty")
        with pytest.raises(JournalError):
            JournalReader(tmp_path / "missing")

    def test_corrupt_run_meta_fails_closed(self, journal):
        (journal / "journal.json").write_text("{not json")
        with pytest.raises(JournalError):
            JournalReader(journal)




# ------------------------------------------------------------- bisect
class TestBisect:
    @staticmethod
    def _streams(n, first_bad):
        a = {t: t * 7 for t in range(1, n + 1)}
        b = {t: (t * 7 if t < first_bad else t * 7 + 1)
             for t in range(1, n + 1)}
        return a, b

    def test_finds_exact_boundary(self):
        for first_bad in (2, 3, 57, 100):
            a, b = self._streams(100, first_bad)
            assert bisect_divergence(a, b) == first_bad
            assert first_divergence_linear(a, b) == first_bad

    def test_divergence_at_first_common_tick(self):
        a, b = self._streams(10, 1)
        assert bisect_divergence(a, b) == 1

    def test_no_divergence(self):
        a, _ = self._streams(50, 99)
        assert bisect_divergence(a, dict(a)) is None
        assert bisect_divergence(a, {}) is None

    def test_partial_overlap(self):
        # run B recorded from a later checkpoint: only the overlap counts
        a = {t: t for t in range(1, 101)}
        b = {t: (t if t < 80 else t + 1) for t in range(50, 121)}
        assert bisect_divergence(a, b) == 80

    def test_healed_divergence_after_boundary_raises(self):
        # diverged at 10, healed at 11, diverged again 12..32: the
        # forward persistence probes see the re-agreement and refuse
        a = {t: 0 for t in range(1, 33)}
        b = {t: (0 if t < 10 or t == 11 else 1) for t in range(1, 33)}
        with pytest.raises(ValueError):
            bisect_divergence(a, b)
        assert first_divergence_linear(a, b) == 10

    def test_pure_transient_blip_needs_linear_scan(self):
        # streams re-agree at the tail: bisect's persistence assumption
        # makes the blip invisible (documented) — linear finds it
        a = {t: 0 for t in range(1, 33)}
        b = dict(a)
        b[7] = 1
        assert bisect_divergence(a, b) is None
        assert first_divergence_linear(a, b) == 7


def test_bisect_and_field_diff_name_the_perturbed_tick_and_leaf():
    """Two port runs from one seed; the second has one NPC's Gold (which
    no phase reads or writes) bumped just before tick 13.  The digest
    streams part at tick 13 for good: bisect_divergence names it, and
    field_diff of the two states after tick 13 names that bank and cell
    and nothing else."""
    runs, states = [], []
    for perturb in (False, True):
        w = _world(False)
        k = w.kernel
        stream = {}
        for _ in range(30):
            if perturb and k.tick_count == 12:
                cs = k.state.classes["NPC"]
                col = k.store.spec("NPC").slot("Gold").col
                i32 = cs.i32.clone()
                i32[5, col] += 1
                k.state = with_class(k.state, "NPC", cs.replace(i32=i32))
            w.tick()
            stream[k.tick_count] = k.last_counters["state_digest"] & 0xFFFFFFFF
            if k.tick_count == 13:
                states.append(k.state)
        runs.append(stream)
    assert bisect_divergence(*runs) == 13
    assert first_divergence_linear(*runs) == 13
    diff = field_diff(*states)
    col = GameWorld(WorldConfig(npc_capacity=8), device="cpu").kernel.registry.spec(
        "NPC").slot("Gold").col
    assert [d["key"] for d in diff] == ["c/NPC/i32"]
    assert diff[0]["count"] == 1
    cell = diff[0]["cells"][0]
    assert cell["index"] == (5, col) and cell["b"] == cell["a"] + 1
