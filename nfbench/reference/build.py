"""The start state of a deployment, from the inputs the benchmark drew.

Every room seeds its first ``seeded`` rows of the fighter class: alive,
scene and group as the recipe says, HP at its maximum, the drawn camp,
position (z = 0) and target, no last attacker (the null object handle,
-1), and the recipe's stats in the EFFECTVALUE
group of the stat record.  The attack heartbeat of row ``r`` first fires
at tick ``1 + r % period`` and then every period; regeneration fires every
period from tick ``period``; both run forever.  The room's key is
``(0, seed)``.

Cells the tick never reads or writes (identity, names, config ids) are
taken from ``base``, the program's start state: the reference claims
nothing about them, and the tick passes them through.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .tick import STAT_RECORD, Geometry, Layout, _key

EFFECTVALUE = 1
NULL_HANDLE = -1


def world_inputs(seed: int, n: int, extent: float, camps: int, device) -> Dict[str, torch.Tensor]:
    """The world recipe's draws from ``numpy.random.default_rng(seed)``:
    positions ``(n, 3)``, then targets ``(n, 2)``, uniform in the extent
    and rounded to float32, then camps, as [1, n, ...] tensors."""
    r = np.random.default_rng(seed)
    pos = r.uniform(0.0, extent, (n, 3)).astype(np.float32)[:, :2]
    tgt = r.uniform(0.0, extent, (n, 2)).astype(np.float32)
    camp = r.integers(0, camps, n)
    return {"pos": torch.from_numpy(np.ascontiguousarray(pos))[None].to(device),
            "tgt": torch.from_numpy(tgt)[None].to(device),
            "camp": torch.from_numpy(camp.astype(np.int32))[None].to(device),
            "seed": torch.tensor([seed], dtype=torch.int64, device=device)}


def touched_i32(lay: Layout, cname: str):
    """The int columns of a class that the tick reads or writes."""
    names = {"HP", "MP", "SP", "Camp", "SceneID", "GroupID", "DeadTick", "LastAttacker"}
    names |= set(lay.stat_cols.get(cname, {}))
    return [col for name, col in lay.i32[cname].items() if name in names]


def initial_rooms(base: Mapping[str, torch.Tensor], lay: Layout, geo: Geometry,
                  recipe: Mapping, inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    st = dict(base)
    cname = geo.fighter
    c, v = lay.i32[cname], lay.vec[cname]
    n_seed = int(recipe["seeded"])
    n_rooms = inputs["pos"].shape[0]
    dev = inputs["pos"].device
    i32 = base[_key(cname, "i32")].clone()
    i32[..., touched_i32(lay, cname)] = 0
    i32[:, :n_seed, c["SceneID"]] = int(recipe["scene"])
    i32[:, :n_seed, c["GroupID"]] = int(recipe["group"])
    i32[:, :n_seed, c["HP"]] = int(recipe["hp"])
    i32[:, :n_seed, c["Camp"]] = inputs["camp"].to(torch.int32)
    i32[:, :n_seed, c["LastAttacker"]] = NULL_HANDLE
    st[_key(cname, "i32")] = i32

    vec = torch.zeros_like(base[_key(cname, "vec")])
    vec[:, :n_seed, v["Position"], :2] = inputs["pos"]
    vec[:, :n_seed, v["TargetPos"], :2] = inputs["tgt"]
    st[_key(cname, "vec")] = vec

    alive = torch.zeros_like(base[_key(cname, "alive")])
    alive[:, :n_seed] = True
    st[_key(cname, "alive")] = alive

    rec = torch.zeros_like(base[_key(cname, f"records.{STAT_RECORD}.i32")])
    sc = lay.stat_cols[cname]
    for stat, key in (("MAXHP", "hp"), ("HPREGEN", "regen"), ("ATK_VALUE", "atk"),
                      ("DEF_VALUE", "def"), ("MOVE_SPEED", "move_speed")):
        rec[:, :n_seed, EFFECTVALUE, sc[stat]] = int(recipe[key])
    st[_key(cname, f"records.{STAT_RECORD}.i32")] = rec

    slots = lay.timers[cname]
    shape = base[_key(cname, "timers.next_fire")].shape
    nf = torch.zeros(shape, dtype=torch.int32, device=dev)
    iv = torch.ones(shape, dtype=torch.int32, device=dev)
    rem = torch.zeros(shape, dtype=torch.int32, device=dev)
    act = torch.zeros(shape, dtype=torch.bool, device=dev)
    period = max(1, int(round(float(recipe["attack_period_s"]) / geo.dt)))
    regen = max(1, int(round(float(recipe["regen_period_s"]) / geo.dt)))
    rows = torch.arange(n_seed, dtype=torch.int32, device=dev)
    first = 1 + rows % period if period > 1 else torch.full_like(rows, period)
    for slot, start, every in ((slots["Attack"], first, period),
                               (slots["Regen"], torch.full_like(rows, regen), regen)):
        nf[:, :n_seed, slot] = start
        iv[:, :n_seed, slot] = every
        rem[:, :n_seed, slot] = -1
        act[:, :n_seed, slot] = True
    st[_key(cname, "timers.next_fire")] = nf
    st[_key(cname, "timers.interval")] = iv
    st[_key(cname, "timers.remain")] = rem
    st[_key(cname, "timers.active")] = act

    st["tick"] = torch.zeros(n_rooms, dtype=torch.int32, device=dev)
    seed = inputs["seed"].to(torch.int64)
    st["rng"] = torch.stack([torch.zeros_like(seed), seed & 0xFFFFFFFF], dim=1)
    return st
