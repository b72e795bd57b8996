"""Distributed execution: device meshes, the sharded world tick, the
collectives, row migration, the spatial preset, the elastic mesh, rooms
and the multi-process bootstrap.

Counterpart of ``noahgameframe_tpu/parallel``, with the same public
names; its ``shard_map`` and ``jax.lax`` collectives are
:mod:`.collectives` here.
"""

from .elastic import Autoscaler, AutoscalePolicy, DigestControl, ElasticMesh
from .mesh import ROOMS_AXIS, SHARD_AXIS, Mesh, make_mesh, replicated, row_sharding
from .multihost import (
    DistRendezvous,
    global_mesh,
    init_distributed,
    rendezvous_via_master,
    serve_dist,
)
from .rooms import (
    ROOM_EXCLUDED,
    ROOM_PACK_SPEC,
    RoomBatch,
    RoomBinPacker,
    RoomDirectory,
    RoomSlotsFull,
    pack_room_blob,
    room_digest,
    unpack_room_blob,
    world_room_leaf_items,
)
from .rowmigrate import (
    RowMigrationModule,
    SpatialPlacement,
    canonical_digest,
    mesh_migrate_class,
    migrate_rows,
)
from .shard import ShardedKernel, room_shardings, shard_rows_by_cell, world_shardings
from .spatial import SpatialGeom, SpatialState, SpatialWorld

__all__ = [
    "Autoscaler",
    "AutoscalePolicy",
    "DigestControl",
    "DistRendezvous",
    "ElasticMesh",
    "Mesh",
    "RowMigrationModule",
    "SpatialPlacement",
    "canonical_digest",
    "global_mesh",
    "init_distributed",
    "mesh_migrate_class",
    "migrate_rows",
    "pack_room_blob",
    "rendezvous_via_master",
    "room_digest",
    "room_shardings",
    "serve_dist",
    "unpack_room_blob",
    "world_room_leaf_items",
    "ROOM_EXCLUDED",
    "ROOM_PACK_SPEC",
    "ROOMS_AXIS",
    "RoomBatch",
    "RoomBinPacker",
    "RoomDirectory",
    "RoomSlotsFull",
    "SHARD_AXIS",
    "ShardedKernel",
    "SpatialGeom",
    "SpatialState",
    "SpatialWorld",
    "make_mesh",
    "replicated",
    "row_sharding",
    "shard_rows_by_cell",
    "world_shardings",
]
