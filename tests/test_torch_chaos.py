"""scripts/chaos_smoke.run on the port's cluster, held against the JAX
package.

The five-role cluster over chaos_smoke's world (64 NPC rows, 8 seeded,
regen every 0.1 s with MAXHP raised over HP, no combat or movement, so
the world evolves with no host input) runs under the seeded fault plan
(seed 7: refusals, drops, dups, delays, corruption, truncation and a
timed login-master partition).  The game role checkpoints, is killed,
goes DOWN at the master, is revived from its checkpoint over a fresh
world (``resume=True``), comes back UP and ticks on.  Every check of the
smoke must hold on the port (``chip_smoke.kill_revive`` and
``chaos_counters``); the revived world's NPC banks, tick and rng must
equal the port's fault-free control world and the JAX package's, each
ticked to the revived tick; and the same scenario on the JAX cluster
must pass the same checks, with its ``nf_chaos_faults_total`` samples on
the revived game's ``/metrics`` labelled as the port's are.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

import chip_smoke as cs

NPCS = 8
SEED = 7
KINDS = {"drop_out", "drop_in", "dup_out", "dup_in", "delay_out", "delay_in", "truncate",
         "corrupt", "refuse", "partition_in", "partition_out"}


def build_world(P, seed: int = SEED):
    """chaos_smoke.build_world in either package."""
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    w = P.world.GameWorld(P.world.WorldConfig(
        npc_capacity=64, player_capacity=8, seed=seed, combat=False, movement=False,
        regen=True, middleware=False, regen_period_s=0.1), **kw).start()
    if 1 not in w.scene.scenes:
        w.scene.create_scene(1)
    if 1 not in w.scene.scenes[1].groups:
        w.scene.request_group(1)
    w.seed_npcs(NPCS, hp=100)
    k = w.kernel
    k.state = k.store.record_write_rows(
        k.state, "NPC", np.arange(NPCS), P.gdefines.COMM_PROPERTY_RECORD,
        int(P.gdefines.PropertyGroup.EFFECTVALUE), {"MAXHP": [200] * NPCS})
    return w


def scenario(P, tmp) -> dict:
    ckpt = tmp / "ckpt"
    # leases twice the smoke's 0.6 s / 1.2 s: a loaded test machine (and
    # the JAX revive's compile) stalls the pump past 1.2 s
    c = P.roles.LocalCluster(backend="py", http_port=0, game_world=build_world(P),
                             lease_suspect_seconds=1.5, lease_down_seconds=3.0,
                             game_kwargs={"checkpoint_dir": ckpt, "checkpoint_seconds": 0.3})
    revived = None
    try:
        c.apply_chaos(cs.chaos_plan(P, SEED))
        c.start(timeout=60.0)
        d = cs.ClusterDriver(P, c, timeout=60.0)
        revived, checks, info = cs.kill_revive(d, "Game1", ckpt, build_world(P), hard=False)
        control = build_world(P)
        cs.drive_control(control, revived.kernel.tick_count)
        checks["world matches fault-free control"] = cs.banks_equal(
            P, revived.kernel.state, P.checkpoint._flatten_state(control.kernel.state))
        counters, chaos_lines = cs.chaos_counters(d, revived)
        checks.update(counters)
        return {"checks": checks, "info": info, "tick": revived.kernel.tick_count,
                "flat": P.checkpoint._flatten_state(revived.kernel.state),
                "chaos": chaos_lines}
    finally:
        c.shut()
        if revived is not None and revived not in c.roles:
            revived.shut()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: scenario(cs.cluster_package(pkg), tmp_path_factory.mktemp(name))
            for name, pkg in (("port", "noahgameframe_tpu_torch"), ("jax", "noahgameframe_tpu"))}


def test_port_passes_every_chaos_smoke_check(runs):
    checks = runs["port"]["checks"]
    assert len(checks) == 14
    assert not [k for k, ok in checks.items() if not ok], checks


def test_jax_passes_the_same_checks(runs):
    assert runs["jax"]["checks"].keys() == runs["port"]["checks"].keys()
    assert not [k for k, ok in runs["jax"]["checks"].items() if not ok]


def test_revived_banks_equal_the_jax_control_at_the_same_tick(runs):
    P = cs.cluster_package("noahgameframe_tpu")
    control = build_world(P)
    cs.drive_control(control, runs["port"]["tick"])
    ref = P.checkpoint._flatten_state(control.kernel.state)
    port = runs["port"]["flat"]
    keys = [k for k in ref if k.startswith("c/NPC/")]
    assert keys and int(port["tick"]) == int(ref["tick"]) == runs["port"]["tick"]
    assert np.array_equal(np.asarray(port["rng"]), np.asarray(ref["rng"]))
    for k in keys:
        assert np.array_equal(np.asarray(port[k]), np.asarray(ref[k])), k


def _labels(lines):
    out = set()
    for ln in lines:
        m = re.match(r"nf_chaos_faults_total\{([^}]*)\} (\S+)$", ln)
        assert m, ln
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        assert sorted(labels) == ["kind", "link"], ln
        out.add((labels["link"], labels["kind"]))
    return out


def test_chaos_samples_on_metrics_labelled_as_jax(runs):
    """The revived game's samples: its own links only, with the label
    names and link values of the JAX package's (which kinds fired depends
    on how many messages each run carried)."""
    port, ref = _labels(runs["port"]["chaos"]), _labels(runs["jax"]["chaos"])
    assert port and ref
    assert {link for link, _k in port} == {link for link, _k in ref}
    assert all(link.startswith("game6.") for link, _k in port)
    assert {k for _l, k in port} | {k for _l, k in ref} <= KINDS
