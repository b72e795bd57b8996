"""Journal replay across packages.

A game role journals a run (a checkpoint at its start, then the client
events through its dispatch tables and a digest mark per tick).  A
journal recorded by the JAX package's role replays digest-clean through
the port's role, and one recorded by the port's role replays digest-clean
through the JAX package's; both record the same digests.  A replay
perturbed at one tick diverges there, and ``bisect_divergence`` and
``dump_divergence`` name that tick.
"""

from __future__ import annotations

import pytest

import noahgameframe_tpu.replay.bisect as jbisect
import noahgameframe_tpu.replay.journal as jjournal
import noahgameframe_tpu.replay.replayer as jreplayer
import noahgameframe_tpu_torch.replay.bisect as tbisect
import noahgameframe_tpu_torch.replay.journal as tjournal
import noahgameframe_tpu_torch.replay.replayer as treplayer
from test_torch_game_role import JAX, PORT, bench_world
from test_torch_parity import one_intra_op_thread  # noqa: F401

N_NPC = 512
FRAMES = 16
PERTURB_TICK = 9


def record(pkg, root, perturb_at=None):
    """Journal one scripted run of ``pkg``'s role under ``root``; returns
    (journal dir, checkpoint dir)."""
    w, t = pkg["wire"], pkg["transport"]
    mid = pkg["game"].MsgID
    jdir, cdir = root / "journal", root / "ckpt"
    world = bench_world(pkg, N_NPC)
    role = pkg["game"].GameRole(
        pkg["base"].RoleConfig(6, 0, "Rec", "127.0.0.1", 0), backend="py", world=world,
        cross_server_sync=False, interest_radius=8.0, journal_dir=jdir,
        checkpoint_dir=cdir, checkpoint_seconds=1e9,
    )
    role.server.send_raw = lambda c, m, b: True
    role.checkpoint_now()
    me = w.Ident(svrid=99, index=1)

    def client(msg_id, msg):
        role.server.dispatch.feed(
            [t.NetEvent(t.EV_MSG, 1001, int(msg_id), w.wrap(msg, player_id=me))])

    npc = role.kernel.store._hosts["NPC"].row_guid[3]
    now, dt = 1000.0, world.config.dt * 1.0001
    for f in range(FRAMES):
        if f == 1:
            client(mid.REQ_ENTER_GAME, w.ReqEnterGameServer(account=b"ada", name=b"Ada"))
        if f in (3, 6, 11):
            client(mid.REQ_MOVE, w.ReqAckPlayerMove(
                target_pos=[w.Position(x=4.0 * f, y=3.0 + f, z=0.0)]))
        if f == 5:
            client(mid.REQ_SKILL_OBJECTX, w.ReqAckUseSkill(effect_data=[w.EffectData(
                effect_ident=w.Ident(svrid=npc.head, index=npc.data))]))
        if perturb_at is not None and role.kernel.tick_count + 1 == perturb_at:
            # an input the journal never sees
            role.kernel.set_property(npc, "HP", 1)
        now += dt
        role.execute(now)
    role.shut()
    return jdir, cdir


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    base = tmp_path_factory.mktemp("replay")
    (base / "jax").mkdir()
    (base / "port").mkdir()
    (base / "bad").mkdir()
    return {
        "jax": record(JAX, base / "jax"),
        "port": record(PORT, base / "port"),
        "bad": record(PORT, base / "bad", perturb_at=PERTURB_TICK),
    }


def test_recorded_digests_equal_across_packages(journals):
    dj = jjournal.read_ticks(journals["jax"][0])
    dt = tjournal.read_ticks(journals["port"][0])
    assert len(dj) == FRAMES and dj == dt
    assert tjournal.read_ticks(journals["jax"][0]) == dj


def test_jax_journal_replays_clean_in_the_port(journals):
    jdir, cdir = journals["jax"]
    role = treplayer.make_offline_role(bench_world(PORT, N_NPC))
    rep = treplayer.replay_journal(jdir, checkpoint=cdir, role=role)
    assert rep.ok, rep.summary()
    assert rep.ticks_replayed == FRAMES and rep.events_fed >= 5
    assert rep.digests == jjournal.read_ticks(jdir)
    role.shut()


def test_port_journal_replays_clean_in_jax(journals):
    jdir, cdir = journals["port"]
    role = jreplayer.make_offline_role(bench_world(JAX, N_NPC))
    rep = jreplayer.replay_journal(jdir, checkpoint=cdir, role=role)
    assert rep.ok, rep.summary()
    assert rep.ticks_replayed == FRAMES
    role.shut()


def test_bisect_names_the_injected_tick(journals):
    jdir, cdir = journals["port"]
    npc_row = 3

    def perturb(role, tick):
        if tick == PERTURB_TICK:
            g = role.kernel.store._hosts["NPC"].row_guid[npc_row]
            role.kernel.set_property(g, "HP", 1)

    role = treplayer.make_offline_role(bench_world(PORT, N_NPC))
    rep = treplayer.replay_journal(jdir, checkpoint=cdir, role=role, perturb=perturb)
    role.shut()
    assert not rep.ok and rep.first_divergence == PERTURB_TICK
    assert tbisect.bisect_divergence(rep.expected, rep.digests) == PERTURB_TICK
    # two journals: the live run perturbed outside the journal
    bad_j, bad_c = journals["bad"]
    assert tbisect.bisect_divergence(tjournal.read_ticks(jdir),
                                     tjournal.read_ticks(bad_j)) == PERTURB_TICK
    assert jbisect.bisect_divergence(jjournal.read_ticks(jdir),
                                     jjournal.read_ticks(bad_j)) == PERTURB_TICK
    assert tbisect.main([str(jdir), str(bad_j)]) == 1
    assert tbisect.main([str(jdir), str(journals["jax"][0])]) == 0
    out = tbisect.dump_divergence(jdir, bad_j, world_factory=lambda: bench_world(PORT, N_NPC),
                                  checkpoint_a=cdir, checkpoint_b=bad_c)
    # both replays are clean, so the states agree: the journal never saw
    # the live perturbation (the diff of a replayed journal is empty)
    assert out["tick"] == PERTURB_TICK and out["diff"] == []
