"""The port's binning and combat folds (noahgameframe_tpu_torch/ops) against
the JAX package: the sort-engine cell tables and slot assignments, kernel
1's plain version against the XLA fold and the Pallas fold (interpret
mode), and kernel 2's plain version against the fused Pallas kernel
(interpret mode).  Tolerance is zero everywhere."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noahgameframe_tpu.game.combat import combat_fold_xla
from noahgameframe_tpu.ops import stencil as jst
from noahgameframe_tpu.ops.stencil_pallas import combat_fold_pallas, fused_neighborhood
from noahgameframe_tpu_torch.ops import stencil as tst
from noahgameframe_tpu_torch.ops import stencil_cuda as tsc
from test_torch_parity import one_intra_op_thread  # noqa: F401

WIDTH, CELL, RADIUS = 6, 5.0, 5.0

# name -> (n, seed, vic bucket, att bucket, population knobs); the shapes
# of tests/test_stencil_pallas.py plus ties, edge cells and a siege
CASES = {
    "random": (300, 3, 16, 12, {}),
    "asymmetric": (300, 23, 16, 6, {}),
    "ties": (300, 5, 16, 12, {"atk_hi": 2}),
    "edges": (300, 7, 16, 12, {"edges": True}),
    "siege": (200, 13, 8, 8, {"clump": (0.5, 4.5)}),
    "overflow": (400, 17, 4, 4, {}),
}


def _population(n, seed, clump=None, atk_hi=30, edges=False):
    """A combat-shaped population (tests/test_stencil_pallas.py's
    _combat_arrays); ``edges`` pins half the entities to the grid border
    and beyond it (cell ids clip); atk_hi=2 makes attack ties common."""
    rng = np.random.RandomState(seed)
    extent = WIDTH * CELL
    lo, hi = clump if clump is not None else (0.0, extent)
    pos = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    if edges:
        side = rng.randint(0, 4, n // 2)
        border = np.where(side % 2 == 0, 0.0, extent + 3.0).astype(np.float32)
        pos[: n // 2, 0] = np.where(side < 2, border, pos[: n // 2, 0])
        pos[: n // 2, 1] = np.where(side >= 2, border, pos[: n // 2, 1])
    active = rng.rand(n) < 0.9
    attacking = (rng.rand(n) < 0.5) & active
    atk = rng.randint(0, atk_hi, n).astype(np.float32)
    camp = rng.randint(1, 3, n).astype(np.float32)
    scene = rng.randint(1, 3, n).astype(np.float32)
    group = rng.randint(0, 2, n).astype(np.float32)
    eff = np.where(attacking, atk, 0.0).astype(np.float32)
    rows = np.arange(n, dtype=np.float32)
    return {
        "pos": pos, "active": active, "attacking": attacking,
        "vic": np.stack([pos[:, 0], pos[:, 1], camp, scene, group], -1),
        "att": np.stack([pos[:, 0], pos[:, 1], eff, camp, scene, group, rows], -1),
        "bank": np.stack([pos[:, 0], pos[:, 1], camp, scene, group, eff], -1),
    }


@functools.lru_cache(maxsize=None)
def _tables(case):
    """Both packages' tables for one case, built once per case (the
    tests only read them)."""
    n, seed, kv, ka, knobs = CASES[case]
    p = _population(n, seed, **knobs)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    jvt, jat = jst.build_cell_table_pair(j["pos"], j["active"], j["vic"], j["attacking"],
                                         j["att"], CELL, WIDTH, kv, ka)
    tvt, tat = tst.build_cell_table_pair(t["pos"], t["active"], t["vic"], t["attacking"],
                                         t["att"], CELL, WIDTH, kv, ka)
    jvs, jas = jst.build_cell_slots_pair(j["pos"], j["active"], j["attacking"],
                                         CELL, WIDTH, kv, ka)
    tvs, tas = tst.build_cell_slots_pair(t["pos"], t["active"], t["attacking"],
                                         CELL, WIDTH, kv, ka)
    return (j, jvt, jat, jvs, jas), (t, tvt, tat, tvs, tas)


def _split(table):
    """A table's arrays, and the table with them cleared (its static
    geometry, hashable)."""
    arrays = {f: getattr(table, f) for f in ("payload", "slot_of", "dropped")
              if hasattr(table, f)}
    return arrays, table._replace(**{f: None for f in arrays})


@functools.lru_cache(maxsize=None)
def _pallas_folds(templates):
    """Both Pallas folds in interpret mode under one jax.jit, with the
    tables' geometry static: cases of one shape share a compile, where an
    interpret-mode pallas_call outside jit is traced anew on every call."""

    def run(arrays, bank):
        vt, at, vs, as_ = (t._replace(**a) for t, a in zip(templates, arrays))
        return (combat_fold_pallas(vt, at, RADIUS, interpret=True),
                fused_neighborhood(bank, vs, as_, RADIUS, interpret=True))

    return jax.jit(run)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_matches(case):
    """Payload tables, slot_of and dropped of both builders, overflow
    included (which rows drop is part of the contract)."""
    (_, jvt, jat, jvs, jas), (_, tvt, tat, tvs, tas) = _tables(case)
    for jt, tt in ((jvt, tvt), (jat, tat)):
        np.testing.assert_array_equal(
            np.asarray(jt.payload).view(np.int32), tt.payload.numpy().view(np.int32))
        _eq(jt.slot_of, tt.slot_of)
        assert int(jt.dropped) == int(tt.dropped)
    for js, ts in ((jvs, tvs), (jas, tas)):
        _eq(js.slot_of, ts.slot_of)
        assert int(js.dropped) == int(ts.dropped)
    if case in ("siege", "overflow"):
        assert int(tvt.dropped) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_folds_match_xla_and_pallas(case):
    """Kernel 1's plain version equals the XLA fold and the Pallas fold;
    kernel 2's plain version equals the fused Pallas kernel (inc, bestr
    and the AOI count nbr)."""
    (j, jvt, jat, jvs, jas), (t, tvt, tat, tvs, tas) = _tables(case)
    arrays, templates = zip(*(_split(x) for x in (jvt, jat, jvs, jas)))
    pallas1, pallas2 = _pallas_folds(templates)(arrays, j["bank"])
    inc, bestr = tsc.combat_fold_plain(tvt, tat, RADIUS)
    for j_inc, j_bestr in (combat_fold_xla(jvt, jat, RADIUS), pallas1):
        _eq(j_inc, inc)
        _eq(j_bestr, bestr)
    assert int((inc > 0).sum()) > 0  # the case exercises real hits
    got = tsc.fused_neighborhood_plain(t["bank"], tvs, tas, RADIUS)
    for w, g in zip(pallas2, got):
        _eq(w, g)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the kernel wrappers return their plain versions'
    results and launch nothing."""
    (_, _, _, _, _), (t, tvt, tat, tvs, tas) = _tables("random")
    tsc.reset_launch_counts()
    for a, b in zip(tsc.combat_fold(tvt, tat, RADIUS),
                    tsc.combat_fold_plain(tvt, tat, RADIUS)):
        assert torch.equal(a, b)
    for a, b in zip(tsc.fused_neighborhood(t["bank"], tvs, tas, RADIUS),
                    tsc.fused_neighborhood_plain(t["bank"], tvs, tas, RADIUS)):
        assert torch.equal(a, b)
    assert all(k.launches == 0 for k in tsc.KERNELS.values())


def test_pull_slots_matches():
    (_, jvt, jat, _, _), (_, tvt, tat, _, _) = _tables("overflow")
    j_inc, j_bestr = combat_fold_xla(jvt, jat, RADIUS)
    t_inc, t_bestr = tsc.combat_fold_plain(tvt, tat, RADIUS)
    want = jst.pull_slots(jvt.slot_of, jnp.stack([j_inc, j_bestr], -1), fill=(0, -1))
    _eq(want, tst.pull_slots(tvt.slot_of, torch.stack([t_inc, t_bestr], -1), fill=(0, -1)))


# ------------------------------------------------------------ NF_RADIX
def test_radix_knob_reads_as_jax_reads_it(monkeypatch):
    """A digit value > 0 selects the radix path; anything else (unset,
    empty, 0, a sign, not a digit) keeps the stable argsort."""
    for raw, want in (("", 0), ("0", 0), ("1", 1), ("3", 3), ("-1", 0),
                      ("two", 0), (" 2", 0)):
        monkeypatch.setenv("NF_RADIX", raw)
        assert tst.radix_bits() == want, raw
        jax_radix = raw.isdigit() and int(raw) > 0  # ops/stencil.py:260-261
        assert (tst.radix_bits() > 0) == jax_radix
    monkeypatch.delenv("NF_RADIX")
    assert tst.radix_bits() == 0


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_radix_argsort_equals_jax_and_stable_argsort(bits):
    """Random keys, heavy duplicates, a single cell and one element:
    the port's radix argsort equals the JAX package's and
    ``torch.argsort(stable=True)``, also under ``torch.func.vmap`` (the
    rooms' batched step)."""
    rng = np.random.default_rng(11 + bits)
    for n, hi in ((1, 2), (257, 9), (600, 1), (4096, 1024), (10_000, 156_026)):
        key = rng.integers(0, hi, n).astype(np.int32)
        n_bits = jst._bits_for(hi - 1)
        got = tst._radix_argsort(torch.from_numpy(key), n_bits, bits)
        want = torch.argsort(torch.from_numpy(key), stable=True)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"{n} {hi}")
        ref = jst._radix_argsort(jnp.asarray(key), n_bits, bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"{n} {hi}")
    keys = torch.from_numpy(rng.integers(0, 65, (3, 500)).astype(np.int32))
    batched = torch.func.vmap(lambda k: tst._radix_argsort(k, 7, bits))(keys)
    assert torch.equal(batched.long(), torch.argsort(keys, dim=1, stable=True))


@functools.lru_cache(maxsize=None)
def _argsort_stream():
    """The argsort engine's 30-tick digest stream at 4,096 NPCs; its
    caller unsets NF_RADIX before the first call."""
    from noahgameframe_tpu_torch.game.world import build_benchmark_world

    w = build_benchmark_world(4096, seed=0, device="cpu")
    w.kernel.enable_digest()
    assert w.combat.capture_key()["radix"] == 0
    return [w.tick().counters["state_digest"] for _ in range(30)]


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_radix_tables_and_digest_stream_equal_argsort(bits, monkeypatch):
    """Under NF_RADIX the cell tables (both builders, every case) equal
    the argsort engine's, and a 4,096-NPC world's 30-tick digest stream
    equals the argsort world's.  The references (the cached tables and
    stream) are built with NF_RADIX unset whatever the test order, and
    the radix path is counted to show it ran."""
    from noahgameframe_tpu_torch.game.world import build_benchmark_world

    monkeypatch.delenv("NF_RADIX", raising=False)
    refs = {case: _tables(case)[1] for case in sorted(CASES)}
    want = _argsort_stream()
    calls = []
    radix_argsort = tst._radix_argsort

    def counted(*args, **kwargs):
        calls.append(args[2] if len(args) > 2 else kwargs["bits_per_pass"])
        return radix_argsort(*args, **kwargs)

    monkeypatch.setattr(tst, "_radix_argsort", counted)
    monkeypatch.setenv("NF_RADIX", str(bits))
    for case in sorted(CASES):
        n, _seed, kv, ka, _knobs = CASES[case]
        t, tvt, tat, tvs, tas = refs[case]
        vt, at = tst.build_cell_table_pair(t["pos"], t["active"], t["vic"], t["attacking"],
                                           t["att"], CELL, WIDTH, kv, ka)
        vs, as_ = tst.build_cell_slots_pair(t["pos"], t["active"], t["attacking"],
                                            CELL, WIDTH, kv, ka)
        for a, b in ((vt, tvt), (at, tat), (vs, tvs), (as_, tas)):
            assert torch.equal(a.slot_of, b.slot_of) and int(a.dropped) == int(b.dropped), case
        for a, b in ((vt, tvt), (at, tat)):
            assert torch.equal(a.payload.view(torch.int32), b.payload.view(torch.int32)), case
    assert calls and set(calls) == {bits}
    del calls[:]
    w = build_benchmark_world(4096, seed=0, device="cpu")
    w.kernel.enable_digest()
    assert w.combat.capture_key()["radix"] == bits  # flipping it re-captures
    assert [w.tick().counters["state_digest"] for _ in range(30)] == want
    assert calls and set(calls) == {bits}
