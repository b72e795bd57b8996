"""The port's serving-edge algebra (ops/serving.py, net/serving.py and
utils/hostio.py) against the JAX package's, on the same seeded inputs.

Tolerance 0: every output array is compared for equality, ties and
SENTINEL padding included.  Each seed's case has an empty session (no
candidates), a full seen-table (every slot holds a row), and rows whose
allocation generation changed since they were seen (recycled rows).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import noahgameframe_tpu.net.serving as jns
import noahgameframe_tpu.ops.serving as jops
import noahgameframe_tpu.utils.hostio as jhostio
import noahgameframe_tpu_torch.net.serving as tns
import noahgameframe_tpu_torch.ops.serving as tops
import noahgameframe_tpu_torch.utils.hostio as thostio

C, S, M = 96, 6, 24  # entity rows, sessions, seen/candidate slots


def _case(seed: int):
    """Candidates and a seen-table built so every branch is hit."""
    r = np.random.default_rng(seed)
    cand_rows = np.stack([r.permutation(C)[:M] for _ in range(S)]).astype(np.int32)
    cand_ok = r.random((S, M)) < 0.6
    cand_ok[0] = False                      # an empty session
    cand_ok[1] = True                       # a full visible set
    gen = r.integers(0, 3, C).astype(np.int32)
    qver = r.integers(0, 4, C).astype(np.int32)
    seen_rows = np.full((S, M), jops.SENTINEL, np.int32)
    seen_gen = np.zeros((S, M), np.int32)
    seen_qver = np.zeros((S, M), np.int32)
    for s in range(S):
        k = M if s == 1 else int(r.integers(0, M))   # session 1: a full seen-table
        rows = np.sort(r.permutation(C)[:k]).astype(np.int32)
        seen_rows[s, :k] = rows
        g = gen[rows].copy()
        recycled = r.random(k) < 0.25                 # rows recycled since seen
        g[recycled] += 1
        seen_gen[s, :k] = g
        q = qver[rows].copy()
        q[r.random(k) < 0.3] -= 1                     # moved since seen
        seen_qver[s, :k] = q
    return cand_rows, cand_ok, gen, qver, seen_rows, seen_gen, seen_qver


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interest_delta_equals_jax(seed):
    cand_rows, cand_ok, gen, qver, sr, sg, sq = _case(seed)
    jd = jops.interest_delta(jnp.asarray(cand_rows), jnp.asarray(cand_ok), jnp.asarray(gen),
                             jnp.asarray(qver), jops.SeenTable(jnp.asarray(sr), jnp.asarray(sg),
                                                               jnp.asarray(sq)))
    td = tops.interest_delta(_t(cand_rows), _t(cand_ok), _t(gen), _t(qver),
                             tops.SeenTable(_t(sr), _t(sg), _t(sq)))
    for name in ("vis", "send", "gone", "gone_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, name)),
                                      getattr(td, name).numpy(), err_msg=name)
    for name in ("rows", "gen", "qver"):
        np.testing.assert_array_equal(np.asarray(getattr(jd.seen, name)),
                                      getattr(td.seen, name).numpy(), err_msg=name)
    assert not td.send[0].any() and td.vis[0].eq(tops.SENTINEL).all()
    assert td.gone.any() and td.send.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bump_qver_and_slot_compact_equal_jax(seed):
    r = np.random.default_rng(seed)
    q = r.integers(0, 5, (C, 3)).astype(np.int32)
    prev = q.copy()
    prev[r.random(C) < 0.4, int(r.integers(0, 3))] += 1
    qver = r.integers(0, 9, C).astype(np.int32)
    jv, jp = jops.bump_qver(jnp.asarray(q), jnp.asarray(prev), jnp.asarray(qver))
    tv, tp = tops.bump_qver(_t(q), _t(prev), _t(qver))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    cand_rows, cand_ok, *_ = _case(seed)
    jr, jc = jops.slot_compact(jnp.asarray(cand_rows), jnp.asarray(cand_ok))
    tr, tc = tops.slot_compact(_t(cand_rows), _t(cand_ok))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    # the compacted prefix (what a caller reads) and the permuted tail
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


def test_session_table_matches_jax():
    """Slots, host columns, lazy wipes and seen-tables follow the JAX
    SessionTable through joins, a release, a recycle and a growth."""
    jt, tt = jns.SessionTable(), tns.SessionTable(device="cpu")
    ops = [("ensure", "a", 11, 3), ("ensure", "b", 12, 4), ("seen", 16),
           ("release", "a"), ("ensure", "c", 13, 5), ("reset", "b"),
           *[("ensure", f"x{i}", 20 + i, i) for i in range(9)], ("seen", 16),
           ("invalidate", "c")]
    for op in ops:
        for tbl, pkg in ((jt, "j"), (tt, "t")):
            if op[0] == "ensure":
                tbl.ensure(op[1], op[2], op[3])
            elif op[0] == "release":
                tbl.release(op[1])
            elif op[0] == "reset":
                tbl.reset_view(op[1])
            elif op[0] == "invalidate":
                tbl.invalidate(op[1])
            else:
                seen = tbl.seen_for("NPC", op[1])
                rows = np.arange(tbl.capacity * op[1], dtype=np.int32).reshape(
                    tbl.capacity, op[1])
                if pkg == "j":
                    tbl.store_seen("NPC", seen._replace(rows=jnp.asarray(rows)))
                else:
                    tbl.store_seen("NPC", seen._replace(rows=torch.from_numpy(rows)))
        assert jt.slot_of == tt.slot_of and jt.capacity == tt.capacity
        for col in ("conn_id", "avatar_row", "valid", "room"):
            np.testing.assert_array_equal(getattr(jt, col), getattr(tt, col))
        for a, b in zip(jt.seen.get("NPC", ()), tt.seen.get("NPC", ())):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jns.sessions_seeing_rows(jt, "NPC", np.array([5, 40])) == \
        tns.sessions_seeing_rows(tt, "NPC", np.array([5, 40]))
    counts = np.array([2, 0, 3])
    oj, _ = jns.segments(counts, 8, b"")
    ot, _ = tns.segments(counts, 8, b"")
    np.testing.assert_array_equal(oj, ot)


@pytest.mark.parametrize("cols", [None, 2, [0, 3]])
def test_gather_rows_equals_jax(cols):
    r = np.random.default_rng(3)
    arr = r.standard_normal((50, 5, 3)).astype(np.float32)
    rows = r.integers(0, 50, 13)
    got = thostio.gather_rows(torch.from_numpy(arr), rows, cols=cols)
    want = jhostio.gather_rows(jnp.asarray(arr), rows, cols=cols)
    np.testing.assert_array_equal(want, got)
    empty = thostio.gather_rows(torch.from_numpy(arr), rows[:0], cols=cols)
    assert empty.shape == jhostio.gather_rows(jnp.asarray(arr), rows[:0], cols=cols).shape
