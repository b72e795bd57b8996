"""The port's scene layer (kernel/scene.py, game/scene_process.py) against
the JAX package on the CPU: the cases of tests/test_scene.py, each run on
both packages through their public API with the guids pinned, compared
result for result (group ids, members, hook calls, property values,
broadcast sets, cell keys, errors) and state tree for state tree.
Tolerance 0."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import noahgameframe_tpu.game.scene_process as jsp
import noahgameframe_tpu.kernel as jkernel
import noahgameframe_tpu.kernel.scene as jscene
from noahgameframe_tpu.core import StoreConfig as JStoreConfig
from noahgameframe_tpu_torch.core import schema as tschema
from noahgameframe_tpu_torch.core.datatypes import DataType
from noahgameframe_tpu_torch.core.store import StoreConfig, state_to_numpy
from noahgameframe_tpu_torch.game import scene_process as tsp
from noahgameframe_tpu_torch.kernel import scene as tscene
from noahgameframe_tpu_torch.kernel.kernel import Kernel
from noahgameframe_tpu_torch.kernel.plugin import Plugin, PluginManager

from fixtures import base_registry
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_parity import one_intra_op_thread  # noqa: F401


def port_registry(jreg) -> tschema.ClassRegistry:
    """The port's ClassRegistry with the same class definitions as a JAX
    package registry, in definition order."""

    def conv(x):
        if type(x).__name__ == "DataType":
            return DataType(x.value)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            cls = getattr(tschema, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x

    reg = tschema.ClassRegistry()
    for name in jreg.names():
        reg.define(conv(jreg.get_def(name)))
    return reg


JAX = types.SimpleNamespace(
    Kernel=jkernel.Kernel, StoreConfig=JStoreConfig, Plugin=jkernel.Plugin,
    PluginManager=jkernel.PluginManager, scene=jscene, sp=jsp, registry=base_registry,
    kw={})
PORT = types.SimpleNamespace(
    Kernel=Kernel, StoreConfig=StoreConfig, Plugin=Plugin, PluginManager=PluginManager,
    scene=tscene, sp=tsp, registry=lambda: port_registry(base_registry()),
    kw={"device": "cpu"})


def build_pm(p):
    pm = p.PluginManager()
    kernel = p.Kernel(p.registry(), p.StoreConfig(default_capacity=256), dt=1.0,
                      class_names=["IObject", "Player", "NPC"], **p.kw)
    scene = p.scene.SceneModule()
    pm.register_plugin(p.Plugin("ScenePlugin", [kernel, scene]))
    return pm, kernel, scene


def setup_world(p, with_seeds=False):
    pm, kernel, scene = build_pm(p)
    pm.start()
    kernel.store.guids.pin(500)
    seeds = []
    if with_seeds:
        kernel.elements.add_element("NPC", "Goblin", {"HP": 120, "MAXHP": 120, "HPREGEN": 3})
        seeds = [p.scene.SeedSpec("Goblin", "NPC", position=(3.0, 4.0, 0.0))]
    scene.create_scene(1, seeds=seeds)
    scene.create_scene(2)
    return pm, kernel, scene


def _s(guids):
    return [str(g) for g in guids]


def case_group_allocation_and_seeding(p, log):
    pm, kernel, scene = setup_world(p, with_seeds=True)
    gid = scene.request_group(1)
    npcs = scene.objects_in_group(1, gid, "NPC")
    npc = npcs[0]
    log += [gid, _s(npcs), kernel.get_property(npc, "ConfigID"),
            kernel.get_property(npc, "HP"), kernel.get_property(npc, "Position")]
    gid2 = scene.request_group(1)
    log += [gid2, _s(scene.objects_in_group(1, gid2, "NPC")),
            _s(scene.objects_in_scene(1, "NPC")),
            _s(scene.scenes[1].groups[gid].seeded)]
    assert log[:5] == [1, log[1], "Goblin", 120, (3.0, 4.0, 0.0)] and len(log[1]) == 1
    return kernel


def case_enter_scene_hooks_order_and_membership(p, log):
    pm, kernel, scene = setup_world(p)
    gid = scene.request_group(1)
    calls = []
    scene.before_enter_scene.append(lambda g, s, gr: calls.append(("be", str(g), s, gr)))
    scene.after_enter_scene.append(lambda g, s, gr: calls.append(("ae", str(g), s, gr)))
    scene.before_leave_scene.append(lambda g, s, gr: calls.append(("bl", str(g), s, gr)))
    scene.after_leave_scene.append(lambda g, s, gr: calls.append(("al", str(g), s, gr)))
    kernel.register_property_event(
        "Player", "SceneID", lambda c, n, rows: calls.append(("prop", n, rows.tolist())))
    kernel.register_property_event(
        "Player", "GroupID", lambda c, n, rows: calls.append(("prop", n, rows.tolist())))
    pl = kernel.create_object("Player", {"Name": "alice"})
    scene.enter_scene(pl, 1, gid)
    log += [list(calls), _s(scene.objects_in_group(1, gid, "Player")),
            kernel.get_property(pl, "SceneID")]
    assert [c[0] for c in calls] == ["bl", "be", "prop", "prop", "al", "ae"]
    calls.clear()
    scene.enter_scene(pl, 2, 0)
    log += [list(calls), _s(scene.objects_in_group(1, gid, "Player")),
            _s(scene.objects_in_scene(2, "Player"))]
    assert calls[0][0] == "bl" and calls[0][2:] == (1, gid)
    return kernel


def case_swap_group_within_scene_fires_swap_hook(p, log):
    pm, kernel, scene = setup_world(p)
    g1, g2 = scene.request_group(1), scene.request_group(1)
    swaps = []
    scene.on_swap_group.append(lambda g, s, gr: swaps.append((s, gr)))
    pl = kernel.create_object("Player")
    scene.enter_scene(pl, 1, g1)
    scene.enter_scene(pl, 1, g2)
    scene.enter_scene(pl, 1, g2)  # no move, no hook
    log += [swaps]
    assert swaps == [(1, g2)]
    return kernel


def case_broadcast_targets_public_vs_private(p, log):
    pm, kernel, scene = setup_world(p)
    gid = scene.request_group(1)
    p1, p2, p3 = (kernel.create_object("Player") for _ in range(3))
    npc = kernel.create_object("NPC", scene=1, group=gid)
    scene.enter_scene(p1, 1, gid)
    scene.enter_scene(p2, 1, gid)
    scene.enter_scene(p3, 2, 0)
    log += [_s(scene.broadcast_targets(npc, public=True)),
            _s(scene.broadcast_targets(npc, public=False)),
            _s(scene.broadcast_targets(p1, public=False))]
    p4 = kernel.create_object("Player")
    scene.enter_scene(p4, 1, 0)
    log += [_s(scene.broadcast_targets(p4, public=True))]
    assert sorted(log[0]) == sorted(_s([p1, p2])) and log[1] == []
    assert sorted(log[3]) == sorted(_s([p1, p2, p4]))
    return kernel


def case_release_group_destroys_members(p, log):
    pm, kernel, scene = setup_world(p, with_seeds=True)
    gid = scene.request_group(1)
    pl = kernel.create_object("Player")
    scene.enter_scene(pl, 1, gid)
    destroyed = []
    kernel.register_class_event(lambda g, c, ev: destroyed.append((str(g), c, int(ev))))
    log += [scene.release_group(1, gid), destroyed, kernel.store.live_count("NPC"),
            kernel.store.live_count("Player"), scene.scenes[1].free_groups,
            scene.request_group(1)]
    assert log[0] == 2 and log[2] == log[3] == 0 and log[5] == gid
    return kernel


def case_cell_key_encoding(p, log):
    pm, kernel, scene = setup_world(p)
    gid = scene.request_group(1)
    pl = kernel.create_object("Player")
    scene.enter_scene(pl, 1, gid)
    key = np.asarray(scene.cell_key(kernel.state, "Player"))
    _, row = kernel.store.row_of(pl)
    log += [key.tolist(), str(key.dtype)]
    assert key[row] == 1 * p.scene.MAX_GROUPS_PER_SCENE + gid
    return kernel


def case_enter_unknown_scene_rejected(p, log):
    pm, kernel, scene = setup_world(p)
    pl = kernel.create_object("Player")
    for args in ((99, 0), (1, 42)):
        with pytest.raises(KeyError) as ei:
            scene.enter_scene(pl, *args)
        log.append(str(ei.value))
    return kernel


def case_scene_process_normal_vs_clone(p, log):
    pm, kernel, scene = build_pm(p)
    sp = p.sp.SceneProcessModule(scene)
    pm.register_plugin(p.Plugin("SceneProcessPlugin", [sp]))
    pm.start()
    kernel.store.guids.pin(500)
    kernel.elements.add_element("NPC", "Goblin", {"HP": 120, "MAXHP": 120})
    scene.create_scene(1)
    scene.create_scene(7, seeds=[p.scene.SeedSpec("Goblin", "NPC", position=(1.0, 2.0, 0.0))])
    kernel.elements.add_element("Scene", "7", {"SceneType": p.sp.SCENE_TYPE_CLONE})
    a = kernel.create_object("Player")
    b = kernel.create_object("Player")
    log += [sp.enter(a, 1), sp.enter(b, 1), sp.enter(a, 3)]
    ca, cb = sp.enter(a, 7), sp.enter(b, 7)
    log += [ca, cb, sorted(scene.scenes[7].groups), _s(scene.objects_in_scene(7, "NPC"))]
    kernel.destroy_object(a)
    log += [sorted(scene.scenes[7].groups), scene.scenes[7].free_groups]
    cb2 = sp.enter(b, 7)
    log += [cb2, sorted(scene.scenes[7].groups), kernel.store.live_count("NPC")]
    assert log[:2] == [1, 1] and ca != cb and ca not in log[8] and cb2 != cb
    return kernel


def case_group_id_exhaustion_is_typed_and_recycling_recovers(p, log):
    pm, kernel, scene = setup_world(p)
    gids = [scene.request_group(1, seed_npcs=False)
            for _ in range(p.scene.MAX_GROUPS_PER_SCENE - 1)]
    with pytest.raises(p.scene.GroupIdsExhausted) as ei:
        scene.request_group(1, seed_npcs=False)
    log += [ei.value.scene_id, ei.value.limit, str(ei.value), gids[-1],
            scene.request_group(2, seed_npcs=False)]
    scene.release_group(1, gids[41])
    log += [scene.request_group(1, seed_npcs=False)]
    with pytest.raises(ValueError):
        scene.request_group(1, group_id=gids[3])
    scene.release_group(1, gids[7])
    log += [scene.request_group(1, group_id=gids[7]), scene.scenes[1].free_groups]
    assert log[5] == gids[41] and log[6] == gids[7]
    return kernel


CASES = {f.__name__[5:]: f for f in (
    case_group_allocation_and_seeding,
    case_enter_scene_hooks_order_and_membership,
    case_swap_group_within_scene_fires_swap_hook,
    case_broadcast_targets_public_vs_private,
    case_release_group_destroys_members,
    case_cell_key_encoding,
    case_enter_unknown_scene_rejected,
    case_scene_process_normal_vs_clone,
    case_group_id_exhaustion_is_typed_and_recycling_recovers,
)}


@pytest.mark.parametrize("case", list(CASES))
def test_scene_case_matches_jax(case):
    la, lb = [], []
    ka = CASES[case](JAX, la)
    kb = CASES[case](PORT, lb)
    assert lb == la
    assert {str(g): h for g, h in kb.store.guid_map.items()} == \
        {str(g): h for g, h in ka.store.guid_map.items()}
    assert_tree_equal(jax_tree(ka.state), state_to_numpy(kb.state))
