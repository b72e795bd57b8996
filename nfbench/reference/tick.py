"""One tick of a batch of rooms, written out in plain PyTorch.

The semantics are the game's (BASELINE config 4; NoahGameFrame's
heartbeats, NFSkillPlugin's AoE and NFCPropertyModule's stat groups):

1. heartbeats: a timer fires when it is active, its row is alive and the
   tick has reached its next firing; it then moves on by its interval
   (finite timers count down and stop at zero);
2. wander: a live walker with HP > 0 steps ``MOVE_SPEED / 10000`` world
   units a second towards its target (none under ``MOVE_GATE``); one that
   would reach it lands on it and draws a fresh target in the extent from
   the tick's key (``fold_in(fold_in(rng, tick), 1)``);
3. AoE: every alive row is binned by its cell (row-major, clipped to the
   grid); a cell holds its ``kv`` lowest alive rows as victims and its
   ``ka`` lowest attackers (rows whose ``Attack`` timer fired, alive, HP >
   0, no ``SKILL_GATE``).  A placed victim with HP > 0 takes the sum of the
   attack of every placed attacker in its own or a neighbouring cell that
   lies within the radius, of another camp, in its scene and group, less
   its defence, at least 1 a hit; HP floors at 0; the strongest such
   attacker (ties to the lowest row) becomes ``LastAttacker``, as the
   handle ``class_index << 24 | row``;
4. death: a row that reached HP 0 stamps ``DeadTick = tick + 1``; one dead
   for the respawn time gets its ``MAXHP`` back;
5. regen: rows whose ``Regen`` timer fired, alive with HP > 0, add their
   regeneration to HP, MP and SP, up to the maxima;
6. stats: each final stat is the sum of its record's group rows;
7. the tick counter advances.

A room is independent of every other: all tensors carry a leading room
axis ``R`` and nothing crosses it.  Every leaf that the tick leaves alone
is passed through unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from . import arith

F32 = torch.float32
HANDLE_ROW_BITS = 24
STAT_RECORD = "CommPropertyValue"
REGEN_CHANNELS = (("HP", "MAXHP", "HPREGEN"), ("MP", "MAXMP", "MPREGEN"),
                  ("SP", "MAXSP", "SPREGEN"))
# the counters of the tick that the reference works out, by name
COUNTERS = ("aoi_attacker_overflow_drops", "aoi_victim_overflow_drops",
            "combat_damage_total", "combat_hits", "deaths", "events_fired",
            "respawns", "tick")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the state keeps what the tick reads: per class, the int
    columns (``i32``), the vector columns (``vec``), the timer slots, the
    stat record's columns and the class's handle index."""

    i32: Mapping[str, Mapping[str, int]]
    vec: Mapping[str, Mapping[str, int]]
    timers: Mapping[str, Mapping[str, int]]
    stat_cols: Mapping[str, Mapping[str, int]]
    class_index: Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The deployment's tick parameters (the configuration file's
    ``geometry``)."""

    extent: float
    radius: float
    cell_size: float
    width: int
    kv: int
    ka: int
    dt: float
    respawn_ticks: int
    fighter: str = "NPC"
    regen_classes: Tuple[str, ...] = ("Player", "NPC")
    speed_unit: float = 10000.0

    @classmethod
    def from_config(cls, geo: Mapping) -> "Geometry":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in geo.items() if k in fields}
        if "regen_classes" in kw:
            kw["regen_classes"] = tuple(kw["regen_classes"])
        return cls(**kw)


def _key(cname: str, leaf: str) -> str:
    return f"classes.{cname}.{leaf}"


def _schedule(st: Dict[str, torch.Tensor], lay: Layout, new: Dict[str, torch.Tensor]):
    """Advance every timer; returns each class's fired mask [R, C, T]."""
    tick = st["tick"]
    fired = {}
    for cname in lay.timers:
        nf = st[_key(cname, "timers.next_fire")]
        iv = st[_key(cname, "timers.interval")]
        rem = st[_key(cname, "timers.remain")]
        act = st[_key(cname, "timers.active")]
        alive = st[_key(cname, "alive")]
        due = act & (tick[:, None, None] >= nf) & alive[:, :, None]
        rem2 = torch.where(due & (rem > 0), rem - 1, rem)
        new[_key(cname, "timers.next_fire")] = torch.where(due, nf + iv, nf)
        new[_key(cname, "timers.remain")] = rem2
        new[_key(cname, "timers.active")] = act & ~(due & (rem2 == 0))
        fired[cname] = due
    return fired


def _wander(i32, vec, alive, key, lay: Layout, geo: Geometry, fdt):
    cname = geo.fighter
    c, v = lay.i32[cname], lay.vec[cname]
    n_rooms, n = alive.shape
    speed = i32[..., c["MOVE_SPEED"]].to(F32) * arith.recip(geo.speed_unit)
    speed = torch.where(i32[..., c["MOVE_GATE"]] > 0, 0.0, speed)
    speed = torch.where(i32[..., c["HP"]] > 0, speed, 0.0)
    step = (speed * float(np.float32(geo.dt))).to(fdt)
    pos = vec[:, :, v["Position"], :2].to(fdt)
    tgt = vec[:, :, v["TargetPos"], :2].to(fdt)
    delta = tgt - pos
    sq = arith.fma(delta[..., 1], delta[..., 1], delta[..., 0] * delta[..., 0])
    dist = arith.sqrt(sq + float(np.float32(1e-12)))
    arrived = dist <= torch.clamp(step, min=float(np.float32(1e-6)))
    fresh = arith.uniform(key, n * 2, 0.0, geo.extent).view(n_rooms, n, 2).to(fdt)
    tgt = torch.where((arrived & alive)[..., None], fresh, tgt)
    walk = arith.fma(delta / dist[..., None], step[..., None].expand_as(delta), pos)
    moved = torch.where(arrived[..., None], pos + delta, walk)
    new_pos = torch.where(alive[..., None], moved, pos)
    new_pos = torch.clamp(new_pos, 0.0, float(np.float32(geo.extent)))
    out = vec.clone()
    out[:, :, v["Position"], :2] = new_pos.to(F32)
    out[:, :, v["TargetPos"], :2] = tgt.to(F32)
    return out


def _ranks(gcell: torch.Tensor, active: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Each active row's rank among the active rows of its cell, in row
    order (flat over rooms: a room's cells are its own keys)."""
    key = torch.where(active, gcell, sentinel).reshape(-1)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    head = torch.searchsorted(skey, skey, side="left")
    ranked = torch.arange(key.numel(), device=key.device) - head
    rank = torch.empty_like(ranked)
    rank[order] = ranked
    return rank.view(active.shape)


def aoe_pairs(pos, alive, attacking, camp, scene, group, eff_atk, geo: Geometry, fdt,
              block: int = 1 << 17):
    """The AoE fold: per row, the summed attack it takes (int64), the
    strongest attacker's row (-1 for none), the overflow counts per room,
    and the number of occupied victim-attacker candidate pairs."""
    n_rooms, n = alive.shape
    dev = alive.device
    w = geo.width
    n_cells = w * w
    inv = arith.recip(geo.cell_size)
    cx = torch.floor(pos[..., 0] * inv).to(torch.int32).clamp(0, w - 1).long()
    cy = torch.floor(pos[..., 1] * inv).to(torch.int32).clamp(0, w - 1).long()
    cell = cy * w + cx
    gcell = torch.arange(n_rooms, device=dev)[:, None] * n_cells + cell
    sentinel = n_rooms * n_cells
    vplaced = alive & (_ranks(gcell, alive, sentinel) < geo.kv)
    arank = _ranks(gcell, attacking, sentinel)
    aplaced = attacking & (arank < geo.ka)
    flat = torch.arange(n_rooms * n, device=dev).view(n_rooms, n)
    table = torch.full((sentinel * geo.ka,), -1, dtype=torch.int64, device=dev)
    table[(gcell * geo.ka + arank)[aplaced]] = flat[aplaced]
    table = table.view(sentinel, geo.ka)

    posf = pos.reshape(-1, 2).to(fdt)
    ea_all = eff_atk.reshape(-1).long()
    camp_all, scene_all, group_all = camp.reshape(-1), scene.reshape(-1), group.reshape(-1)
    cell_all = cell.reshape(-1)
    r2 = float(geo.radius) * float(geo.radius)
    inc = torch.zeros(n_rooms * n, dtype=torch.int64, device=dev)
    best = torch.full((n_rooms * n,), -1, dtype=torch.int64, device=dev)
    pairs = 0
    victims = torch.nonzero(vplaced.reshape(-1)).squeeze(1)
    for s in range(0, victims.numel(), block):
        v = victims[s:s + block]
        room = v // n
        vc = cell_all[v]
        vx, vy = vc % w, vc // w
        cands = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nx, ny = vx + dx, vy + dy
                inside = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < w)
                g = room * n_cells + ny.clamp(0, w - 1) * w + nx.clamp(0, w - 1)
                cands.append(torch.where(inside[:, None], table[g], -1))
        cand = torch.cat(cands, dim=1)
        has = cand >= 0
        pairs += int(has.sum())
        a = cand.clamp(min=0)
        ddx = posf[v, 0][:, None] - posf[a, 0]
        ddy = posf[v, 1][:, None] - posf[a, 1]
        ea = ea_all[a]
        hit = (has & (arith.fma(ddx, ddx, ddy * ddy) <= r2) & (ea != 0)
               & (camp_all[a] != camp_all[v][:, None])
               & (scene_all[a] == scene_all[v][:, None])
               & (group_all[a] == group_all[v][:, None]))
        inc[v] = torch.where(hit, ea, 0).sum(dim=1)
        top = torch.where(hit, ea, -1).amax(dim=1)
        first = torch.where(hit & (ea == top[:, None]), a % n, n).amin(dim=1)
        best[v] = torch.where(top > 0, first, -1)
    drops_v = (alive & ~vplaced).sum(dim=1)
    drops_a = (attacking & ~aplaced).sum(dim=1)
    return inc.view(n_rooms, n), best.view(n_rooms, n), drops_v, drops_a, pairs


def step(st: Mapping[str, torch.Tensor], lay: Layout, geo: Geometry,
         fdt: torch.dtype = F32, stats: dict = None):
    """One tick of every room: ``(state', counters)``; ``counters`` maps
    each name of :data:`COUNTERS` to an int64 [R].  ``stats``, when given,
    accumulates ``pairs`` (the occupied candidate pairs the fold
    examined), ``combat_hits``, ``deaths`` (rows that reached HP 0) and
    ``respawns``."""
    new: Dict[str, torch.Tensor] = dict(st)
    tick = st["tick"]
    n_rooms = tick.shape[0]
    dev = tick.device
    fired = _schedule(st, lay, new)
    cname = geo.fighter
    c = lay.i32[cname]
    i32 = st[_key(cname, "i32")].clone()
    alive = st[_key(cname, "alive")]
    slots = lay.timers[cname]

    key = arith.fold_in(arith.fold_in(st["rng"], tick),
                        torch.ones(n_rooms, dtype=torch.int64, device=dev))
    vec = _wander(i32, st[_key(cname, "vec")], alive, key, lay, geo, fdt)
    new[_key(cname, "vec")] = vec

    hp = i32[..., c["HP"]]
    attacking = fired[cname][..., slots["Attack"]] & alive & (hp > 0)
    attacking = attacking & (i32[..., c["SKILL_GATE"]] == 0)
    eff_atk = torch.where(attacking, i32[..., c["ATK_VALUE"]], 0)
    pos = vec[:, :, lay.vec[cname]["Position"], :2]
    inc, best, drops_v, drops_a, pairs = aoe_pairs(
        pos, alive, attacking, i32[..., c["Camp"]], i32[..., c["SceneID"]],
        i32[..., c["GroupID"]], eff_atk, geo, fdt)
    incoming = torch.where(alive & (hp > 0), inc, 0)
    dmg = torch.clamp(incoming - i32[..., c["DEF_VALUE"]], min=0)
    dmg = torch.where(incoming > 0, torch.clamp(dmg, min=1), 0)
    i32[..., c["HP"]] = torch.clamp(hp - dmg, min=0).to(torch.int32)
    handle = (lay.class_index[cname] << HANDLE_ROW_BITS) | torch.clamp(best, min=0)
    i32[..., c["LastAttacker"]] = torch.where(incoming > 0, handle,
                                              i32[..., c["LastAttacker"]]).to(torch.int32)

    hp = i32[..., c["HP"]]
    dead_tick = i32[..., c["DeadTick"]]
    now = tick[:, None]
    just_died = alive & (hp <= 0) & (dead_tick == 0)
    due = ((dead_tick > 0) & (now + 1 - dead_tick >= geo.respawn_ticks) & alive
           & (i32[..., c["MAXHP"]] > 0))
    dead_tick = torch.where(just_died, now + 1, dead_tick)
    i32[..., c["HP"]] = torch.where(due, i32[..., c["MAXHP"]], hp)
    i32[..., c["DeadTick"]] = torch.where(due, 0, dead_tick).to(torch.int32)
    new[_key(cname, "i32")] = i32

    for rc in geo.regen_classes:
        if rc not in lay.timers or "Regen" not in lay.timers[rc]:
            continue
        rcols = lay.i32[rc]
        ri32 = new[_key(rc, "i32")].clone()
        ralive = st[_key(rc, "alive")]
        live = fired[rc][..., lay.timers[rc]["Regen"]] & ralive & (ri32[..., rcols["HP"]] > 0)
        for cur, mx, rg in REGEN_CHANNELS:
            if cur not in rcols or rg not in rcols:
                continue
            val, cap, reg = ri32[..., rcols[cur]], ri32[..., rcols[mx]], ri32[..., rcols[rg]]
            grown = torch.minimum(val + reg, torch.maximum(cap, val))
            ri32[..., rcols[cur]] = torch.where(live & (reg > 0), grown, val)
        new[_key(rc, "i32")] = ri32

    for sc, cols in lay.stat_cols.items():
        rec = st[_key(sc, f"records.{STAT_RECORD}.i32")]
        totals = torch.sum(rec, dim=2, dtype=torch.int32)
        si32 = new[_key(sc, "i32")].clone()
        for name, rcol in cols.items():
            si32[..., lay.i32[sc][name]] = totals[..., rcol]
        new[_key(sc, "i32")] = si32

    new["tick"] = tick + 1
    if stats is not None:
        for name, n in (("pairs", pairs), ("combat_hits", int((incoming > 0).sum())),
                        ("deaths", int(just_died.sum())), ("respawns", int(due.sum()))):
            stats[name] = stats.get(name, 0) + n
    flag = ((drops_v + drops_a) > 0).long()
    counters = {
        "aoi_attacker_overflow_drops": drops_a,
        "aoi_victim_overflow_drops": drops_v,
        "combat_damage_total": dmg.long().sum(dim=1),
        "combat_hits": (incoming > 0).long().sum(dim=1),
        "deaths": torch.zeros(n_rooms, dtype=torch.int64, device=dev),
        "events_fired": flag + just_died.long().sum(dim=1) + due.long().sum(dim=1),
        "respawns": due.long().sum(dim=1),
        "tick": (tick + 1).long(),
    }
    return new, counters
