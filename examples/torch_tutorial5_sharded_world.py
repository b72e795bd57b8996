"""Tutorial 5 — shard one world over a device mesh, on the PyTorch port.

The port's counterpart of examples/tutorial5_sharded_world.py.  The
reference scales by running more server processes and splitting players
across them by consistent hash (SURVEY §2.5).  The port scales the SAME
world over more shards instead: every entity bank is split into row
blocks along its capacity axis, one block a shard (``ShardedKernel``),
and each shard steps its block; combat gathers the fold's columns from
every shard, so it reads across shard boundaries with no relay server and
no resharding logic in user code.

The mesh is a virtual one of 4 shards on one device (``cuda:0``, or the
CPU with ``--device cpu``), so it runs on any one card.  The ``alive`` /
``damaged`` line equals the JAX tutorial's.

Run:  python examples/torch_tutorial5_sharded_world.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.game import GameWorld, WorldConfig  # noqa: E402
from noahgameframe_tpu_torch.parallel import ShardedKernel, make_mesh  # noqa: E402

N_SHARDS = 4


def main(device=None) -> None:
    world = GameWorld(
        WorldConfig(npc_capacity=1024, player_capacity=64, extent=128.0,
                    attack_period_s=0.2, middleware=False),
        device=device,
    )
    world.start()
    world.scene.create_scene(1, width=128.0)
    world.seed_npcs(800, camps=2)

    dev = world.kernel.device
    mesh = make_mesh(N_SHARDS, device="cuda:0" if dev.type == "cuda" else dev, virtual=True)
    sk = ShardedKernel(world.kernel, mesh=mesh)
    sk.place()  # split the world onto the mesh
    print(f"mesh: {sk.mesh} over {mesh.size} shards")

    rows = [b.classes["NPC"].i32.shape[0] for b in sk.blocks]
    print(f"i32 bank sharding: row blocks {rows} on {[str(d) for d in mesh.devices]}")

    sk.run_device(60)  # 60 sharded ticks, no host sync between them

    hp = world.kernel.store.column(world.kernel.state, "NPC", "HP").cpu().numpy()
    alive = world.kernel.state.classes["NPC"].alive.cpu().numpy()
    print(f"alive: {alive.sum()}  damaged: {(hp[alive] < 100).sum()} "
          f"(combat crossed shard boundaries)")
    assert (hp[alive] < 100).any()
    print("done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
