"""Relational persistence: the reference MySQL module's API + driver FSM.

Reference: NFMysqlPlugin exposes a key-value-style API over tables —
`Updata/Query/Select/Delete/Exists/Keys` with (table, key, fieldVec,
valueVec) signatures (`NFCMysqlModule.h:32-40`) plus a driver manager
with reconnect keepalive.  Two engines sit behind the same surface:
stdlib sqlite3 here (serverless), and the real MySQL wire protocol in
persist/mysql.py — SqlDriver selects by registration (ip/port ⇒ MySQL).
Rows are (id TEXT PRIMARY KEY, field columns added on demand) exactly
like the reference's generated NFrame.sql tables.

A copy of ``noahgameframe_tpu/persist/sql.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import sqlite3
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

_ID = "id"


def _q(name: str) -> str:
    """Quote an identifier; reject anything that cannot be a column."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad identifier {name!r}")
    return f'"{name}"'


class SqlModule:
    """Updata/Query/Select/Delete/Exists/Keys over a SQLite database."""

    def __init__(self, path: Union[str, Path] = ":memory:") -> None:
        self._conn = sqlite3.connect(str(path), check_same_thread=False)
        self._lock = threading.Lock()
        self._known_cols: Dict[str, set] = {}

    # -- schema management (CREATE TABLE on demand) ---------------------
    def _ensure(self, table: str, fields: Sequence[str]) -> None:
        t = _q(table)
        with self._lock:
            cols = self._known_cols.get(table)
            if cols is None:
                self._conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {t} ({_ID} TEXT PRIMARY KEY)"
                )
                cols = {
                    r[1]
                    for r in self._conn.execute(f"PRAGMA table_info({t})")
                }
                self._known_cols[table] = cols
            for f in fields:
                if f not in cols:
                    self._conn.execute(f"ALTER TABLE {t} ADD COLUMN {_q(f)}")
                    cols.add(f)

    # -- reference-shaped API -------------------------------------------
    def updata(self, table: str, key: str, fields: Sequence[str],
               values: Sequence[Union[str, bytes, int, float]]) -> bool:
        """Upsert one row (the reference's spelling)."""
        if len(fields) != len(values):
            return False
        self._ensure(table, fields)
        with self._lock:
            if not fields:  # key-only touch
                self._conn.execute(
                    f"INSERT OR IGNORE INTO {_q(table)} ({_ID}) VALUES (?)",
                    [key],
                )
            else:
                cols = ", ".join(_q(f) for f in fields)
                marks = ", ".join("?" for _ in fields)
                sets = ", ".join(f"{_q(f)}=excluded.{_q(f)}" for f in fields)
                self._conn.execute(
                    f"INSERT INTO {_q(table)} ({_ID}, {cols}) "
                    f"VALUES (?, {marks}) ON CONFLICT({_ID}) DO UPDATE SET {sets}",
                    [key, *values],
                )
            self._conn.commit()
        return True

    def query(self, table: str, key: str,
              fields: Sequence[str]) -> Optional[List]:
        """Read selected fields of one row (reference Query)."""
        self._ensure(table, fields)
        cols = ", ".join(_q(f) for f in fields)
        with self._lock:
            row = self._conn.execute(
                f"SELECT {cols} FROM {_q(table)} WHERE {_ID}=?", [key]
            ).fetchone()
        return list(row) if row is not None else None

    def select(self, table: str, key: str) -> Optional[Dict[str, object]]:
        """Whole row as a field->value dict."""
        self._ensure(table, ())
        with self._lock:
            cur = self._conn.execute(
                f"SELECT * FROM {_q(table)} WHERE {_ID}=?", [key]
            )
            row = cur.fetchone()
            if row is None:
                return None
            names = [d[0] for d in cur.description]
        return dict(zip(names, row))

    def delete(self, table: str, key: str) -> bool:
        self._ensure(table, ())
        with self._lock:
            n = self._conn.execute(
                f"DELETE FROM {_q(table)} WHERE {_ID}=?", [key]
            ).rowcount
            self._conn.commit()
        return n > 0

    def exists(self, table: str, key: str) -> bool:
        self._ensure(table, ())
        with self._lock:
            row = self._conn.execute(
                f"SELECT 1 FROM {_q(table)} WHERE {_ID}=?", [key]
            ).fetchone()
        return row is not None

    def keys(self, table: str, like: str = "%") -> List[str]:
        self._ensure(table, ())
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {_ID} FROM {_q(table)} WHERE {_ID} LIKE ?", [like]
            ).fetchall()
        return sorted(r[0] for r in rows)

    def close(self) -> None:
        self._conn.close()

    def ping(self) -> bool:
        """Connection health probe (the driver manager's keepalive)."""
        try:
            with self._lock:
                self._conn.execute("SELECT 1")
            return True
        except sqlite3.Error:
            return False


# ---------------------------------------------------------------------------
# Driver manager: multi-server registration + keepalive/reconnect FSM
# ---------------------------------------------------------------------------

DRV_DISCONNECTED, DRV_CONNECTED = 0, 1


@dataclasses.dataclass
class SqlServerConfig:
    """One database server row (reference AddMysqlServer signature:
    serverID, dns/ip, port, dbName, user, password, reconnect time/count —
    NFCMysqlModule.h:32-40).  The sqlite engine only uses db_name as the
    database path; the endpoint/credential fields ride along so a real
    MySQL driver slots behind the same registration call."""

    server_id: int
    db_name: str = ":memory:"
    ip: str = ""
    port: int = 0
    user: str = ""
    password: str = ""
    reconnect_time: float = 10.0
    reconnect_count: int = -1  # -1 = retry forever


class SqlDriver:
    """One managed connection with a reconnect state machine."""

    def __init__(self, config: SqlServerConfig) -> None:
        self.config = config
        self.state = DRV_DISCONNECTED
        self.module = None  # SqlModule or mysql.MysqlModule
        self.reconnects_left = config.reconnect_count
        self.last_error = ""  # most recent connect failure, for operators
        self._next_attempt = 0.0

    def _drop_module(self) -> None:
        """Close the dead connection before discarding it — reconnect
        cycles must not leak file handles / lock-holding transactions."""
        if self.module is not None:
            try:
                self.module.close()
            except (sqlite3.Error, OSError):
                pass
            self.module = None

    def connect(self, now: float = 0.0) -> bool:
        """Engine selection mirrors the reference AddMysqlServer: an
        ip/port endpoint means a real MySQL wire connection
        (persist.mysql.MysqlModule, handshake + native-password auth);
        otherwise the serverless sqlite engine."""
        self._drop_module()
        from .mysql import MysqlError, MysqlModule

        try:
            if self.config.ip and self.config.port:
                self.module = MysqlModule(
                    self.config.ip,
                    self.config.port,
                    self.config.user,
                    self.config.password,
                    "" if self.config.db_name == ":memory:"
                    else self.config.db_name,
                )
            else:
                self.module = SqlModule(self.config.db_name)
            self.state = DRV_CONNECTED
            return True
        except (sqlite3.Error, MysqlError, OSError) as e:
            self.last_error = str(e)  # e.g. "Access denied" vs refused
            self.state = DRV_DISCONNECTED
            self._next_attempt = now + self.config.reconnect_time
            return False

    def mark_dead(self, now: float) -> None:
        self._drop_module()
        self.state = DRV_DISCONNECTED
        self._next_attempt = now + self.config.reconnect_time

    def keep_alive(self, now: float) -> bool:
        """Ping; on failure enter DISCONNECTED and retry after
        reconnect_time, at most reconnect_count times (reference driver
        keepalive semantics).  Returns current health."""
        if self.state == DRV_CONNECTED:
            if self.module is not None and self.module.ping():
                return True
            self.mark_dead(now)
            return False
        if now >= self._next_attempt and self.reconnects_left != 0:
            if self.reconnects_left > 0:
                self.reconnects_left -= 1
            return self.connect(now)
        return False


class SqlDriverManager:
    """Multiple named servers behind one Updata/Query/... facade.

    Mirrors the reference's driver manager: register servers by id,
    operations route to a healthy driver (an explicit server_id or the
    first connected one), and `execute(now)` runs the 10 s keepalive
    sweep from the main loop."""

    def __init__(self, keepalive_seconds: float = 10.0) -> None:
        self.keepalive_seconds = float(keepalive_seconds)
        self._drivers: Dict[int, SqlDriver] = {}
        self._last_sweep = 0.0
        self._now = 0.0  # latest injected time (advanced by execute())

    def add_server(self, config: SqlServerConfig, now: float = 0.0) -> SqlDriver:
        old = self._drivers.get(config.server_id)
        if old is not None:
            old._drop_module()  # re-registration must not leak the old link
        drv = SqlDriver(config)
        drv.connect(now)
        self._drivers[config.server_id] = drv
        self._now = max(self._now, now)
        return drv

    def driver(self, server_id: Optional[int] = None) -> Optional[SqlDriver]:
        if server_id is not None:
            d = self._drivers.get(server_id)
            return d if d is not None and d.state == DRV_CONNECTED else None
        for d in self._drivers.values():
            if d.state == DRV_CONNECTED:
                return d
        return None

    def execute(self, now: float) -> None:
        self._now = max(self._now, now)
        if now - self._last_sweep < self.keepalive_seconds:
            return
        self._last_sweep = now
        for d in self._drivers.values():
            d.keep_alive(now)

    # -- facade (reference-shaped, returns False/None on any failure) ----
    def _call(self, server_id: Optional[int], op, fail):
        """Route to a healthy driver; failures return the `fail` value
        instead of leaking sqlite3.Error into the caller's main-loop
        tick.  A statement/data error on a healthy connection (bad bind
        value, constraint) does NOT kill the driver — only a failed
        re-ping marks it dead, arming the backoff from the latest
        injected time."""
        from .mysql import MysqlError

        d = self.driver(server_id)
        if d is None or d.module is None:
            return fail
        try:
            return op(d.module)
        except (sqlite3.Error, MysqlError, OSError, ValueError):
            # ValueError: identifier validation (_q/_bq) — a caller bug,
            # not a connection fault; either way the tick must not die.
            # MysqlError/OSError: wire engine faults — ping-check below
            # marks the driver dead so routing fails over immediately.
            if not d.module.ping():
                d.mark_dead(self._now)
            return fail

    def updata(self, table, key, fields, values, server_id=None) -> bool:
        return self._call(
            server_id, lambda m: m.updata(table, key, fields, values), False
        )

    def query(self, table, key, fields, server_id=None):
        return self._call(
            server_id, lambda m: m.query(table, key, fields), None
        )

    def select(self, table, key, server_id=None):
        return self._call(server_id, lambda m: m.select(table, key), None)

    def delete(self, table, key, server_id=None) -> bool:
        return self._call(server_id, lambda m: m.delete(table, key), False)

    def exists(self, table, key, server_id=None) -> bool:
        return self._call(server_id, lambda m: m.exists(table, key), False)

    def keys(self, table, like="%", server_id=None):
        return self._call(server_id, lambda m: m.keys(table, like), [])

    def close(self) -> None:
        """Terminal shutdown: drivers close AND lose their reconnect
        budget, so a stray execute() after close cannot reopen files."""
        for d in self._drivers.values():
            d._drop_module()
            d.state = DRV_DISCONNECTED
            d.reconnects_left = 0


def emit_ddl(registry, class_names: Sequence[str]) -> str:
    """Generate CREATE TABLE statements for save-flagged properties — the
    NFrame.sql emitter of the reference codegen (`FileProcess.h:38-72`)."""
    out: List[str] = []
    for cname in class_names:
        cdef = registry.get_def(cname)
        cols = [f"  {_q(_ID)} TEXT PRIMARY KEY"]
        for p in cdef.properties:
            if not (p.save or p.cache):
                continue
            sql_t = {
                1: "BIGINT", 2: "DOUBLE", 3: "TEXT",
                4: "TEXT", 5: "TEXT", 6: "TEXT",
            }[int(p.type)]
            cols.append(f"  {_q(p.name)} {sql_t}")
        body = ",\n".join(cols)
        out.append(f"CREATE TABLE IF NOT EXISTS {_q(cname)} (\n{body}\n);")
    return "\n".join(out)
