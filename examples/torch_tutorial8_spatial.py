"""Tutorial 8 — spatial slab sharding: migration and halos, on the PyTorch
port.

The port's counterpart of examples/tutorial8_spatial.py.  Tutorial 5
shards the ENTITY axis and folds combat over the whole class on every
shard.  This tutorial shows the second strategy (`parallel/spatial.py`):
partition SPACE into per-shard slabs, keep the binning shard-local,
exchange one dense attacker halo plane with each neighbor, and MIGRATE
entities between shard banks when their cell crosses a slab boundary —
the analog of the reference re-homing a player to another game server
through the World relay (NFCGSSwichServerModule / NFCWorldNet_Server).

The mesh is a virtual one of 4 shards on one device (``cuda:0``, or the
CPU with ``--device cpu``), so it runs on any one card.  Entities move by
``cos``/``sin`` of random angles, whose float32 results differ between
libraries in the last bit now and then, so its numbers are the port's own;
the population is conserved on every device.

Run:  python examples/torch_tutorial8_spatial.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from noahgameframe_tpu_torch.parallel import SpatialGeom, SpatialWorld, make_mesh  # noqa: E402


def main(device=None, bursts: int = 5) -> None:
    geom = SpatialGeom(
        extent=128.0, cell_size=4.0, width=32, n_shards=4,
        bucket=24, att_bucket=24, radius=4.0, mig_budget=256,
        speed=1.5, attack_period=3,
        regen_per_tick=1, hp_max=80, respawn_ticks=10,
    )
    rng = np.random.default_rng(7)
    n = 2000
    dev = "cuda:0" if device is None or str(device).startswith("cuda") else device
    world = SpatialWorld(geom, make_mesh(geom.n_shards, device=dev, virtual=True))
    world.place(
        rng.uniform(1.0, geom.extent - 1.0, (n, 2)).astype(np.float32),
        np.full(n, 80, np.int32),
        rng.integers(5, 20, n).astype(np.int32),
        (np.arange(n) % 2).astype(np.int32),
    )
    print(f"{n} entities over {geom.n_shards} slabs "
          f"({geom.slab_h} cell rows each), bank={world.bank_size}")

    for burst in range(bursts):
        world.step(10)
        mig, over, drop, misp, vdrop, adrop = world.stats_last.sum(axis=0)
        got = world.gather()
        dead = sum(1 for _, (_, _, h) in got.items() if h == 0)
        print(
            f"tick {world.tick_count:3d}: migrated={mig:4d}/tick "
            f"dead={dead:4d} overflow={over + drop + misp + vdrop + adrop}"
        )

    # every entity still exists exactly once, wherever it wandered
    assert len(world.gather()) == n
    print("population conserved across all migrations - OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
