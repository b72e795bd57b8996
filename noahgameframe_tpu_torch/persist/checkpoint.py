"""Whole-world checkpoint / resume, in the JAX package's format.

Counterpart of ``noahgameframe_tpu/persist/checkpoint.py``.  The reference
persists per entity only (player blobs on destroy), so a crashed game
server loses live NPC state; here the world is one tree of tensors, and a
checkpoint is a device-to-host snapshot of every bank plus the host-side
identity maps (guid allocation, free lists, the string intern table).

Format: one directory with ``arrays.npz`` (every bank, flat key namespace,
``np.savez_compressed``) and ``meta.json`` (guids, free rows, strings,
tick).  Keys, dtypes and meta fields are the JAX package's exactly: the
key ``rng`` is written as ``uint32[2]``, as JAX writes its PRNG key, not as
the port's int64 words.  So a checkpoint saved by either package loads
into the other.

Loading builds each leaf on the kernel's device with the dtype of the
leaf it replaces, and replaces only the classes, ``tick`` and ``rng``
(``state.aux``, the module-owned carried state such as a Verlet cache,
stays the loading world's, as in JAX).  A tick captured as a CUDA graph
therefore keeps its capture: its next replay copies the new leaves into
its inputs.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.datatypes import Guid
from ..core.prng import MASK32
from ..core.store import WorldState, _cpu
from ..core.strings import StringTable


def _flatten_state(state: WorldState) -> Dict[str, np.ndarray]:
    """Every leaf of the world (aux excluded) on the host, under the JAX
    package's checkpoint keys and dtypes."""
    out: Dict[str, np.ndarray] = {
        "tick": np.asarray(_cpu(state.tick), np.int32),
        "rng": _cpu(state.rng).astype(np.uint32),
    }
    for cname, cs in state.classes.items():
        p = f"c/{cname}/"
        out[p + "i32"] = _cpu(cs.i32)
        out[p + "f32"] = _cpu(cs.f32)
        out[p + "vec"] = _cpu(cs.vec)
        out[p + "alive"] = _cpu(cs.alive)
        out[p + "t/next_fire"] = _cpu(cs.timers.next_fire)
        out[p + "t/interval"] = _cpu(cs.timers.interval)
        out[p + "t/remain"] = _cpu(cs.timers.remain)
        out[p + "t/active"] = _cpu(cs.timers.active)
        for rname, rec in cs.records.items():
            rp = f"{p}r/{rname}/"
            out[rp + "i32"] = _cpu(rec.i32)
            out[rp + "f32"] = _cpu(rec.f32)
            out[rp + "vec"] = _cpu(rec.vec)
            out[rp + "used"] = _cpu(rec.used)
    return out


def save_world(kernel, path, modules=()) -> Dict[str, float]:
    """Snapshot the whole world (device state + host identity) to disk,
    atomically: everything is written into a temp sibling directory and
    renamed into place, so a crash mid-save leaves either the previous
    checkpoint or the new one, never a torn arrays.npz/meta.json pair.

    ``modules``: Modules whose ``checkpoint_state()`` host state must
    survive the resume.  Returns the save's split: ``d2h_s`` (the banks
    off the device), ``write_s`` (the compressed npz and meta.json),
    ``bytes_on_disk`` and ``raw_bytes`` (the banks' own size)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    arrays = _flatten_state(kernel.state)
    t1 = time.perf_counter()
    np.savez_compressed(tmp / "arrays.npz", **arrays)
    store = kernel.store
    mod_states = {}
    for m in modules:
        data = m.checkpoint_state()
        if data is not None:
            mod_states[m.name] = data
    meta = {
        "modules": mod_states,
        "class_order": store.class_order,
        "tick_count": kernel.tick_count,
        # the device tick duplicated host-side: load_world cross-checks it
        # against arrays.npz so a mixed pair is rejected, not resumed
        "array_tick": int(arrays["tick"]),
        "strings": store.strings.snapshot(),
        "guids": {f"{g.head}-{g.data}": int(h) for g, h in store.guid_map.items()},
        "hosts": {
            cname: {
                "free": [int(r) for r in host.free],
                "row_guid": [(str(g) if g is not None else None) for g in host.row_guid],
                "live_count": host.live_count,
            }
            for cname, host in store._hosts.items()
        },
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    t2 = time.perf_counter()
    on_disk = sum(f.stat().st_size for f in tmp.iterdir())
    # swap into place: os.replace cannot overwrite a non-empty directory,
    # so an existing checkpoint is renamed aside first (the one window
    # that is not atomic leaves a complete .old copy beside the new one)
    if path.exists():
        old = path.parent / f".{path.name}.old{os.getpid()}"
        if old.exists():
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
    return {"d2h_s": t1 - t0, "write_s": t2 - t1, "bytes_on_disk": on_disk,
            "raw_bytes": sum(a.nbytes for a in arrays.values())}


def peek_checkpoint(path) -> Optional[dict]:
    """Light read-side probe of a checkpoint directory, without a kernel
    or the arrays: ``{"tick_count", "array_tick"}`` from meta.json, or
    None when no complete checkpoint exists (a missing directory, or a
    torn write in flight)."""
    meta_path = Path(path) / "meta.json"
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, ValueError):
        return None
    return {
        "tick_count": int(meta.get("tick_count", 0)),
        "array_tick": int(meta.get("array_tick", meta.get("tick_count", 0))),
    }


def load_world(kernel, path, modules=()) -> Dict[str, float]:
    """Restore a checkpoint into a kernel built from the same schema and
    capacities (a torn pair, other classes or another shape raise
    ValueError before anything changes).  Pass the ``modules`` given to
    save_world; their host state restores after the identity maps, so
    guids resolve.  Returns ``read_s`` (reading and inflating the arrays,
    with the checks) and ``h2d_s`` (building the leaves on the kernel's
    device)."""
    path = Path(path)
    t0 = time.perf_counter()
    meta = json.loads((path / "meta.json").read_text())
    store = kernel.store
    state = kernel.state
    with np.load(path / "arrays.npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    recorded = meta.get("array_tick")
    if recorded is not None and int(recorded) != int(arrays["tick"]):
        raise ValueError(
            f"torn checkpoint: meta.json array_tick={int(recorded)} "
            f"disagrees with arrays.npz tick={int(arrays['tick'])}"
        )
    if meta["class_order"] != store.class_order:
        raise ValueError(
            f"checkpoint classes {meta['class_order']} != store {store.class_order}"
        )

    def arr(key: str, like: torch.Tensor) -> np.ndarray:
        a = arrays[key]
        if a.shape != tuple(like.shape):
            raise ValueError(f"checkpoint {key} shape {a.shape} != {tuple(like.shape)}")
        return a

    staged = {}  # key -> (array, the leaf it replaces), all checked first
    for cname in store.class_order:
        cs = state.classes[cname]
        p = f"c/{cname}/"
        leaves = {p + k: getattr(cs, k) for k in ("i32", "f32", "vec", "alive")}
        leaves.update({p + "t/" + k: getattr(cs.timers, k)
                       for k in ("next_fire", "interval", "remain", "active")})
        for rname, rec in cs.records.items():
            leaves.update({f"{p}r/{rname}/{k}": getattr(rec, k)
                           for k in ("i32", "f32", "vec", "used")})
        staged.update({k: (arr(k, like), like) for k, like in leaves.items()})
    tick = np.asarray(arrays["tick"]).reshape(())
    rng = np.asarray(arrays["rng"]).astype(np.int64) & MASK32
    if rng.shape != tuple(state.rng.shape):
        raise ValueError(f"checkpoint rng shape {rng.shape} != {tuple(state.rng.shape)}")
    t1 = time.perf_counter()

    def dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(a).to(device=like.device, dtype=like.dtype)

    new_classes = {}
    for cname in store.class_order:
        cs = state.classes[cname]
        p = f"c/{cname}/"

        def leaf(key: str) -> torch.Tensor:
            return dev(*staged[p + key])

        new_classes[cname] = cs.replace(
            i32=leaf("i32"), f32=leaf("f32"), vec=leaf("vec"), alive=leaf("alive"),
            timers=cs.timers.replace(
                next_fire=leaf("t/next_fire"), interval=leaf("t/interval"),
                remain=leaf("t/remain"), active=leaf("t/active"),
            ),
            records={
                rname: rec.replace(i32=leaf(f"r/{rname}/i32"), f32=leaf(f"r/{rname}/f32"),
                                   vec=leaf(f"r/{rname}/vec"), used=leaf(f"r/{rname}/used"))
                for rname, rec in cs.records.items()
            },
        )
    kernel.state = state.replace(classes=new_classes, tick=dev(tick, state.tick),
                                 rng=dev(rng, state.rng))
    if kernel.device.type == "cuda":
        torch.cuda.synchronize(kernel.device)
    t2 = time.perf_counter()
    kernel.tick_count = int(meta["tick_count"])
    # host identity: strings restore in place (device columns hold interned
    # handles, and modules may hold references to the table object)
    restored = StringTable.restore(meta["strings"])
    table = store.strings
    with table._lock:
        table._to_id = dict(restored._to_id)
        table._to_str = list(restored._to_str)
    store.guid_map.clear()
    for key, handle in meta["guids"].items():
        store.guid_map[Guid.parse(key)] = int(handle)
    for cname, hmeta in meta["hosts"].items():
        host = store._hosts[cname]
        host.free = [int(r) for r in hmeta["free"]]
        host.row_guid = [Guid.parse(s) if s else None for s in hmeta["row_guid"]]
        host.live_count = int(hmeta["live_count"])
        # the allocation bitmap and the guid columns derive from row_guid
        host.alloc_mask = np.asarray([g is not None for g in host.row_guid], bool)
        host.guid_head = np.asarray(
            [g.head if g is not None else 0 for g in host.row_guid], np.int64)
        host.guid_data = np.asarray(
            [g.data if g is not None else 0 for g in host.row_guid], np.int64)
    mod_states = meta.get("modules", {})
    for m in modules:
        data = mod_states.get(m.name)
        if data is not None:
            m.restore_state(data)
    return {"read_s": t1 - t0, "h2d_s": t2 - t1}
