"""Divergence bisection between two digest streams + state field diff.

Two runs that should agree (CPU vs TPU, 1-shard vs 8-shard mesh, Verlet
skin=0 vs skin=2, live vs replay) each leave a per-tick digest stream.
State divergence is persistent under the tick — once the worlds differ,
their digests keep differing (a uint32 collision every tick thereafter
is astronomically unlikely) — so the first divergent tick is a monotone
boundary and binary search finds it in O(log n) digest compares instead
of a linear scan.  With the tick in hand, replay both runs up to it and
diff the flattened WorldState field by field.

Counterpart of ``noahgameframe_tpu/replay/bisect.py``: the search, the
field diff over the port's checkpoint flattening (the JAX package's keys
and dtypes), :func:`dump_divergence` (replay two journals up to their
first divergent tick and diff the states) and :func:`main`, the
digest-only command line.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np

from ..persist.checkpoint import _flatten_state


def bisect_divergence(a: Mapping[int, int],
                      b: Mapping[int, int]) -> Optional[int]:
    """First tick where the two digest streams disagree, or None.

    Binary search over the common tick range, relying on divergence
    persistence (see module docstring).  The found boundary is verified
    forward at geometrically spaced probes — a divergence that HEALS
    after the boundary breaks the persistence assumption and raises
    ValueError instead of returning a wrong answer.  A purely transient
    blip whose streams re-agree at the tail is invisible here by
    construction (the search never looks at it): use
    :func:`first_divergence_linear` for streams where healing is
    possible."""
    common = sorted(set(a) & set(b))
    if not common:
        return None
    if a[common[0]] != b[common[0]]:
        return common[0]
    if a[common[-1]] == b[common[-1]]:
        return None
    lo, hi = 0, len(common) - 1  # invariant: equal at lo, diverged at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if a[common[mid]] == b[common[mid]]:
            lo = mid
        else:
            hi = mid
    step = 1
    while hi + step < len(common):  # forward persistence probes
        t = common[hi + step]
        if a[t] == b[t]:
            raise ValueError(
                f"digest streams re-agree at tick {t} after diverging at "
                f"{common[hi]} — divergence is not persistent, fall back "
                f"to a linear scan"
            )
        step *= 2
    return common[hi]


def first_divergence_linear(a: Mapping[int, int],
                            b: Mapping[int, int]) -> Optional[int]:
    """Exact linear scan — for streams where divergence might heal
    (e.g. a perturbed value that a later phase clamps back)."""
    for t in sorted(set(a) & set(b)):
        if a[t] != b[t]:
            return t
    return None


def field_diff(state_a, state_b, max_per_key: int = 8) -> List[dict]:
    """Field-level WorldState diff: every flattened bank (see
    persist.checkpoint._flatten_state) where the two states disagree,
    with the first `max_per_key` differing cells spelled out."""
    fa, fb = _flatten_state(state_a), _flatten_state(state_b)
    out: List[dict] = []
    for key in fa:
        va = fa[key]
        vb = fb.get(key)
        if vb is None or va.shape != vb.shape:
            out.append({"key": key, "error": "shape/layout mismatch",
                        "a_shape": list(va.shape),
                        "b_shape": list(vb.shape) if vb is not None else None})
            continue
        neq = np.atleast_1d(va != vb)
        if not neq.any():
            continue
        idx = np.argwhere(neq)
        cells = []
        flat_a, flat_b = np.atleast_1d(va), np.atleast_1d(vb)
        for i in idx[:max_per_key]:
            t = tuple(int(x) for x in i)
            cells.append({"index": t,
                          "a": flat_a[t].item(),
                          "b": flat_b[t].item()})
        out.append({"key": key, "count": int(idx.shape[0]), "cells": cells})
    return out


def dump_divergence(
    journal_a,
    journal_b,
    world_factory=None,
    checkpoint_a=None,
    checkpoint_b=None,
    max_per_key: int = 8,
    device=None,
) -> dict:
    """End-to-end bisect: locate the first divergent tick between two
    journaled runs, replay each side up to it, and return the field
    diff.  Both replays run on ``device`` (``None`` = ``"cuda"``) unless a
    ``world_factory`` supplies the worlds — the point is to materialize the
    states the digests fingerprinted."""
    from .journal import read_ticks
    from .replayer import make_offline_role, replay_journal

    da, db = read_ticks(journal_a), read_ticks(journal_b)
    tick = bisect_divergence(da, db)
    if tick is None:
        return {"tick": None, "diff": []}
    states = []
    for jdir, ckpt in ((journal_a, checkpoint_a), (journal_b, checkpoint_b)):
        role = make_offline_role(
            world_factory() if world_factory is not None else None,
            device=device,
        )
        try:
            replay_journal(jdir, checkpoint=ckpt, role=role, upto=tick)
            states.append(role.kernel.state)
        finally:
            role.shut()
    return {"tick": tick, "diff": field_diff(*states, max_per_key=max_per_key)}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m noahgameframe_tpu_torch.replay.bisect A_JOURNAL B_JOURNAL``
    — digest-only bisection (no state materialization)."""
    import argparse

    from .journal import read_ticks

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("journal_a")
    ap.add_argument("journal_b")
    args = ap.parse_args(argv)
    da, db = read_ticks(args.journal_a), read_ticks(args.journal_b)
    overlap = len(set(da) & set(db))
    tick = bisect_divergence(da, db)
    if tick is None:
        print(f"no divergence across {overlap} common ticks")
        return 0
    print(f"first divergent tick: {tick} "
          f"(a={da[tick]:#010x} b={db[tick]:#010x})")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
