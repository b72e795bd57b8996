"""Persistence: whole-world checkpoints, the per-object blob codec, KV
backends, the RESP client, data agents, the SQL/MySQL modules and the
write-behind pipeline, each in the JAX package's format.  The room blob's
frame lives in :mod:`.rowblob`."""

from .agent import PlayerDataAgent, RoleListStore  # noqa: F401
from .checkpoint import load_world, peek_checkpoint, save_world  # noqa: F401
from .codec import ObjectDataPack, apply_snapshot, resolve_pending, snapshot_object  # noqa: F401
from .kv import FileKV, KVStore, MemoryKV  # noqa: F401
from .mysql import MiniMysql, MysqlClient, MysqlError, MysqlModule  # noqa: F401
from .resp import MiniRedisServer, RespKV  # noqa: F401
from .social import SocialDataAgent  # noqa: F401
from .sql import SqlModule, emit_ddl  # noqa: F401
from .writebehind import (  # noqa: F401
    KVBackend,
    SqlBackend,
    StagingWAL,
    StoreBackend,
    WALError,
    WriteBehindPipeline,
)
