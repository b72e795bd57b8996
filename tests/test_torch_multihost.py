"""The port's multi-process bootstrap (noahgameframe_tpu_torch.parallel.
multihost), case by case after tests/test_multihost.py.

The two-process case runs for real here: two processes join a gloo group
over localhost, build the global mesh (2 processes x 2 virtual CPU
shards), lift one identical world onto it and run ONE sharded world tick
with cross-process collectives; the checksum must match the plain local
tick in both.  The worker is this file, run as a script:

    python tests/test_torch_multihost.py <process_id> <num_processes> <host:port>
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from noahgameframe_tpu_torch.parallel import (  # noqa: E402
    DistRendezvous,
    global_mesh,
    init_distributed,
    make_mesh,
    rendezvous_via_master,
    serve_dist,
)
from test_torch_parity import one_intra_op_thread  # noqa: F401,E402


def _world():
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    w = GameWorld(WorldConfig(npc_capacity=256, player_capacity=16, extent=64.0, seed=7),
                  device="cpu").start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(128)
    return w


def _checksums(mesh):
    """(sharded checksum, local checksum) of one tick: the NPC i32 bank's
    int64 sum after one sharded tick on ``mesh``, psum'd over its shards,
    and after one plain local tick of the same world."""
    from noahgameframe_tpu_torch.parallel import ShardedKernel
    from noahgameframe_tpu_torch.parallel import collectives as coll

    w = _world()
    k = w.kernel
    local_new, _ = k._step(k.state)
    expected = int(local_new.classes["NPC"].i32.to(torch.int64).sum())
    sk = ShardedKernel(k, mesh=mesh)
    sk.place()
    sk.run_device(1)
    parts = [b.classes["NPC"].i32.to(torch.int64).sum() for b in sk.blocks]
    checksum = int(coll.psum(mesh, parts)[0])
    return checksum, expected


def test_init_distributed_noop_for_single_process(monkeypatch):
    monkeypatch.delenv("NF_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("NF_NUM_PROCESSES", "1")
    assert init_distributed() is False  # one process: nothing to join
    mesh = global_mesh(local_devices=["cpu"])
    assert mesh.size >= 1 and not mesh.multiprocess


def test_dist_rendezvous_assignments():
    rz = DistRendezvous(expected=3)
    a = rz.register("hostA", "10.0.0.1:1234")
    b = rz.register("hostB", "10.0.0.2:1234")
    a2 = rz.register("hostA", "ignored")  # idempotent re-register
    assert a["process_id"] == 0 and b["process_id"] == 1
    assert a2["process_id"] == 0
    assert a["coordinator"] == "10.0.0.1:1234"  # first registrant wins
    assert not b["ready"]
    c = rz.register("hostC", "x")
    assert c["ready"] and c["num_processes"] == 3
    assert "error" in rz.register("hostD", "y")  # pod full


def test_rendezvous_via_master_http():
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.master import MasterRole

    m = MasterRole(RoleConfig(3, 1, "M", "127.0.0.1", 0), http_port=0)
    serve_dist(m, expected=2)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            m.execute()
            time.sleep(0.002)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        port = m.http.port
        results = {}

        def join(key, coord):
            results[key] = rendezvous_via_master(
                f"127.0.0.1:{port}", key, coord, timeout_s=10.0, poll_s=0.05)

        t1 = threading.Thread(target=join, args=("h1", "10.1.1.1:9999"))
        t1.start()
        time.sleep(0.2)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/dist", timeout=5) as r:
            status = json.loads(r.read())
        assert status["registered"] == 1 and not status["ready"]
        join("h2", "10.1.1.2:9999")
        t1.join(timeout=10)
        assert results["h1"][0] == "10.1.1.1:9999"
        assert results["h1"][1] == 2
        assert {results["h1"][2], results["h2"][2]} == {0, 1}
    finally:
        stop.set()
        t.join(timeout=2)
        m.shut()


def test_two_process_distributed_tick():
    """Two OS processes join a gloo group over localhost, mesh 2 x 2
    virtual CPU shards, and run ONE sharded tick with cross-process
    collectives: equal checksums in both, equal to the local tick.  (The
    JAX package's counterpart skips: its CPU backend has no multiprocess
    collectives.)"""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, __file__, str(i), "2", coord],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
            outs.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(o["mesh"] == 4 and o["local"] == 2 for o in outs), outs
    assert outs[0]["checksum"] == outs[1]["checksum"], outs
    for o in outs:
        assert o["checksum"] == o["expected"], outs


def test_single_process_sharded_tick_checksum():
    """The worker's computation inline over an 8-shard virtual CPU mesh:
    one sharded tick's checksum equals a plain local tick's."""
    checksum, expected = _checksums(make_mesh(8, device="cpu", virtual=True))
    assert checksum == expected


def _worker(pid: int, nproc: int, coord: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    joined = init_distributed(coord, nproc, pid, backend="gloo")
    assert joined, "the two-process group must join"
    mesh = global_mesh(local_devices=["cpu", "cpu"])
    checksum, expected = _checksums(mesh)
    print(json.dumps({"pid": pid, "mesh": mesh.size, "local": len(mesh.local),
                      "checksum": checksum, "expected": expected}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
