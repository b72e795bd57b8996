"""MySQL client/server wire protocol + the reference's table API over it.

Reference: NFMysqlPlugin speaks real MySQL through mysql-connector
(NFComm/NFMysqlPlugin/NFCMysqlDriver.cpp); its module surface is the
key-value-over-tables API (`NFCMysqlModule.h:32-40`).  No MySQL client
library or server ships in this image, so this module implements the
actual MySQL client/server protocol from scratch:

- packet framing (3-byte LE length + sequence id),
- handshake v10 + HandshakeResponse41 with `mysql_native_password`
  challenge/response auth (SHA1(pw) XOR SHA1(salt . SHA1(SHA1(pw)))),
- COM_QUERY text-protocol resultsets (column definitions, EOF framing,
  length-encoded row values), COM_PING, COM_QUIT,
- OK/ERR/EOF packet parsing.

`MysqlModule` mirrors SqlModule's Updata/Query/... surface over a live
wire connection, and `MiniMysql` is the in-process wire *server* twin
(the MiniRedis pattern, persist/resp.py) — it performs the real
handshake, verifies the client's scramble against the password, and
executes the query on sqlite after a light MySQL→sqlite dialect shim.
Tests therefore exercise genuine protocol bytes end to end without an
external mysqld.

A copy of ``noahgameframe_tpu/persist/mysql.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import re
import socket
import socketserver
import sqlite3
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

# capability flags (the subset this dialect uses)
CLIENT_LONG_PASSWORD = 0x1
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 1 << 19

_CAPS = (
    CLIENT_LONG_PASSWORD
    | CLIENT_CONNECT_WITH_DB
    | CLIENT_PROTOCOL_41
    | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION
    | CLIENT_PLUGIN_AUTH
)

COM_QUIT, COM_QUERY, COM_PING = 0x01, 0x03, 0x0E

AUTH_PLUGIN = b"mysql_native_password"

# MySQL text-protocol column type codes (just the ones emitted here)
TYPE_VAR_STRING = 0xFD


class MysqlError(Exception):
    """Wire-level or server-reported (ERR packet) failure."""

    def __init__(self, msg: str, code: int = 2000):
        super().__init__(msg)
        self.code = code


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def scramble_native(password: str, salt: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _lenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def _lenc_str(b: bytes) -> bytes:
    return _lenc_int(len(b)) + b


def _read_lenc_int(data: bytes, off: int) -> Tuple[Optional[int], int]:
    first = data[off]
    off += 1
    if first < 0xFB:
        return first, off
    if first == 0xFB:  # NULL in row data
        return None, off
    if first == 0xFC:
        return struct.unpack_from("<H", data, off)[0], off + 2
    if first == 0xFD:
        return int.from_bytes(data[off : off + 3], "little"), off + 3
    return struct.unpack_from("<Q", data, off)[0], off + 8


def _read_lenc_str(data: bytes, off: int) -> Tuple[Optional[bytes], int]:
    n, off = _read_lenc_int(data, off)
    if n is None:
        return None, off
    return data[off : off + n], off + n


class _PacketIO:
    """Framed packet reader/writer over a socket (3-byte len + seq)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0
        self._buf = b""

    def reset_seq(self) -> None:
        self.seq = 0

    def read(self) -> bytes:
        hdr = self._exactly(4)
        n = int.from_bytes(hdr[:3], "little")
        self.seq = (hdr[3] + 1) & 0xFF
        return self._exactly(n)

    def write(self, payload: bytes) -> None:
        # >16MB payloads never occur in this API surface
        self.sock.sendall(
            len(payload).to_bytes(3, "little") + bytes([self.seq]) + payload
        )
        self.seq = (self.seq + 1) & 0xFF

    def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise MysqlError("connection closed mid-packet")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def _parse_err(payload: bytes) -> MysqlError:
    code = struct.unpack_from("<H", payload, 1)[0]
    off = 3
    if payload[off : off + 1] == b"#":  # sql-state marker
        off += 6
    return MysqlError(payload[off:].decode("utf-8", "replace"), code)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class MysqlClient:
    """A connected, authenticated MySQL session (text protocol)."""

    def __init__(
        self,
        host: str,
        port: int,
        user: str = "",
        password: str = "",
        database: str = "",
        timeout: float = 5.0,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.io = _PacketIO(self.sock)
        self.server_version = ""
        try:
            self._handshake(user, password, database)
        except BaseException:
            self.sock.close()  # reconnect loops must not leak fds
            raise

    # -- connection phase ---------------------------------------------------

    def _handshake(self, user: str, password: str, database: str) -> None:
        pkt = self.io.read()
        if pkt[0] == 0xFF:
            raise _parse_err(pkt)
        if pkt[0] != 10:
            raise MysqlError(f"unsupported protocol version {pkt[0]}")
        off = 1
        end = pkt.index(b"\x00", off)
        self.server_version = pkt[off:end].decode()
        off = end + 1 + 4  # thread id
        salt = pkt[off : off + 8]
        off += 8 + 1  # filler
        caps = struct.unpack_from("<H", pkt, off)[0]
        off += 2
        if len(pkt) > off:
            off += 1 + 2  # charset, status
            caps |= struct.unpack_from("<H", pkt, off)[0] << 16
            off += 2
            off += 1 + 10  # auth data len, reserved
            if caps & CLIENT_SECURE_CONNECTION:
                # 12 scramble bytes + NUL terminator
                salt = salt + pkt[off : off + 12]
        if not caps & CLIENT_PROTOCOL_41:
            raise MysqlError("server lacks CLIENT_PROTOCOL_41")

        auth = scramble_native(password, salt)
        resp = struct.pack("<IIB23x", _CAPS, 1 << 24, 33)  # utf8_general_ci
        resp += user.encode() + b"\x00"
        resp += bytes([len(auth)]) + auth
        resp += database.encode() + b"\x00"
        resp += AUTH_PLUGIN + b"\x00"
        self.io.write(resp)
        ok = self.io.read()
        if ok[0] == 0xFE:
            # AuthSwitchRequest: plugin name NUL, then fresh auth data.
            # MySQL 8 sends this when the account's default plugin differs
            # from what we offered (e.g. caching_sha2_password accounts
            # that still allow native auth) — re-scramble with the new
            # salt when the server asks for mysql_native_password, fail
            # with the plugin's NAME otherwise (not an opaque byte).
            nul = ok.find(b"\x00", 1)
            if nul < 0:
                raise MysqlError(
                    "malformed AuthSwitchRequest (no plugin terminator; "
                    "pre-4.1 old-password switch is not supported)"
                )
            end = nul
            plugin = ok[1:end]
            if plugin != AUTH_PLUGIN:
                raise MysqlError(
                    "server requests unsupported auth plugin "
                    f"{plugin.decode(errors='replace')!r}"
                    f" (only {AUTH_PLUGIN.decode()} is implemented)"
                )
            new_salt = ok[end + 1:].rstrip(b"\x00")
            self.io.write(scramble_native(password, new_salt))
            ok = self.io.read()
        if ok[0] == 0xFF:
            raise _parse_err(ok)
        if ok[0] != 0x00:
            raise MysqlError(f"unexpected auth reply 0x{ok[0]:02x}")

    # -- command phase ------------------------------------------------------

    def ping(self) -> bool:
        try:
            self.io.reset_seq()
            self.io.write(bytes([COM_PING]))
            return self.io.read()[0] == 0x00
        except (OSError, MysqlError):
            return False

    def close(self) -> None:
        try:
            self.io.reset_seq()
            self.io.write(bytes([COM_QUIT]))
        except OSError:
            pass
        finally:
            self.sock.close()

    def query(self, sql: str) -> Tuple[List[str], List[List[Optional[str]]]]:
        """COM_QUERY.  Returns (column names, rows) — empty for OK-only
        statements.  Raises MysqlError on an ERR packet."""
        self.io.reset_seq()
        self.io.write(bytes([COM_QUERY]) + sql.encode())
        first = self.io.read()
        if first[0] == 0xFF:
            raise _parse_err(first)
        if first[0] == 0x00:  # OK: no resultset
            return [], []
        ncols, _ = _read_lenc_int(first, 0)
        names: List[str] = []
        for _ in range(ncols):
            names.append(self._parse_coldef(self.io.read()))
        self._expect_eof(self.io.read())
        rows: List[List[Optional[str]]] = []
        while True:
            pkt = self.io.read()
            if pkt[0] == 0xFE and len(pkt) < 9:  # EOF
                break
            if pkt[0] == 0xFF:
                raise _parse_err(pkt)
            row: List[Optional[str]] = []
            off = 0
            for _ in range(ncols):
                raw, off = _read_lenc_str(pkt, off)
                row.append(None if raw is None else raw.decode("utf-8"))
            rows.append(row)
        return names, rows

    @staticmethod
    def _parse_coldef(pkt: bytes) -> str:
        off = 0
        for _ in range(4):  # catalog, schema, table, org_table
            _, off = _read_lenc_str(pkt, off)
        name, off = _read_lenc_str(pkt, off)
        return name.decode("utf-8")

    @staticmethod
    def _expect_eof(pkt: bytes) -> None:
        if not (pkt[0] == 0xFE and len(pkt) < 9):
            raise MysqlError("expected EOF between columns and rows")


# ---------------------------------------------------------------------------
# the reference table API over the wire (SqlModule twin)
# ---------------------------------------------------------------------------

_ID = "id"


def _bq(name: str) -> str:
    """Backtick-quote an identifier; reject anything exotic."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad identifier {name!r}")
    return f"`{name}`"


def _lit(v: Union[str, bytes, int, float, None]) -> str:
    """SQL literal with MySQL escaping."""
    if v is None:
        return "NULL"
    if isinstance(v, bytes):
        return "X'" + v.hex() + "'"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    s = s.replace("\\", "\\\\").replace("'", "\\'")
    s = s.replace("\x00", "\\0").replace("\n", "\\n").replace("\r", "\\r")
    return f"'{s}'"


class MysqlModule:
    """Updata/Query/Select/Delete/Exists/Keys over a live MySQL wire
    connection — the same surface as persist.sql.SqlModule, so
    SqlDriver can put either engine behind one registration call.

    Values come back as text (MySQL text protocol), matching the
    reference module's all-strings valueVec contract
    (NFCMysqlModule.h:32-40)."""

    def __init__(
        self,
        host: str,
        port: int,
        user: str = "",
        password: str = "",
        database: str = "",
        timeout: float = 5.0,
    ):
        self._cli = MysqlClient(host, port, user, password, database, timeout)
        self._known_cols: Dict[str, set] = {}

    def _ensure(self, table: str, fields: Sequence[str]) -> None:
        t = _bq(table)
        cols = self._known_cols.get(table)
        if cols is None:
            self._cli.query(
                f"CREATE TABLE IF NOT EXISTS {t} "
                f"(`{_ID}` VARCHAR(128) PRIMARY KEY)"
            )
            _, rows = self._cli.query(f"SHOW COLUMNS FROM {t}")
            cols = {r[0] for r in rows}
            self._known_cols[table] = cols
        for f in fields:
            if f not in cols:
                self._cli.query(f"ALTER TABLE {t} ADD COLUMN {_bq(f)} TEXT")
                cols.add(f)

    # NOTE: like SqlModule, methods RAISE on wire/server failure
    # (MysqlError/OSError) — SqlDriverManager._call owns the
    # catch-ping-markdead policy; swallowing here would blind its
    # dead-driver failover.

    def updata(self, table, key, fields, values) -> bool:
        if len(fields) != len(values):
            return False
        self._ensure(table, fields)
        collist = ", ".join([f"`{_ID}`"] + [_bq(f) for f in fields])
        vallist = ", ".join([_lit(key)] + [_lit(v) for v in values])
        upd = ", ".join(
            f"{_bq(f)}=VALUES({_bq(f)})" for f in fields
        ) or f"`{_ID}`=`{_ID}`"
        self._cli.query(
            f"INSERT INTO {_bq(table)} ({collist}) VALUES ({vallist}) "
            f"ON DUPLICATE KEY UPDATE {upd}"
        )
        return True

    def query(self, table, key, fields):
        self._ensure(table, fields)
        collist = ", ".join(_bq(f) for f in fields) or f"`{_ID}`"
        _, rows = self._cli.query(
            f"SELECT {collist} FROM {_bq(table)} "
            f"WHERE `{_ID}` = {_lit(key)}"
        )
        if not rows:
            return None
        return list(rows[0])

    def select(self, table, key):
        self._ensure(table, ())
        names, rows = self._cli.query(
            f"SELECT * FROM {_bq(table)} WHERE `{_ID}` = {_lit(key)}"
        )
        if not rows:
            return None
        return {n: v for n, v in zip(names, rows[0]) if n != _ID}

    def delete(self, table, key) -> bool:
        self._ensure(table, ())
        self._cli.query(
            f"DELETE FROM {_bq(table)} WHERE `{_ID}` = {_lit(key)}"
        )
        return True

    def exists(self, table, key) -> bool:
        self._ensure(table, ())
        _, rows = self._cli.query(
            f"SELECT 1 FROM {_bq(table)} WHERE `{_ID}` = {_lit(key)}"
        )
        return bool(rows)

    def keys(self, table, like: str = "%"):
        self._ensure(table, ())
        _, rows = self._cli.query(
            f"SELECT `{_ID}` FROM {_bq(table)} "
            f"WHERE `{_ID}` LIKE {_lit(like)} ORDER BY `{_ID}`"
        )
        return [r[0] for r in rows]

    def ping(self) -> bool:
        return self._cli.ping()

    def close(self) -> None:
        self._cli.close()


# ---------------------------------------------------------------------------
# MiniMysql: in-process wire server (test double / dev backend)
# ---------------------------------------------------------------------------

_SHOW_COLS = re.compile(r"^SHOW COLUMNS FROM (`?\w+`?)$", re.I)

_BACKSLASH_UNESCAPE = {
    "\\": "\\", "'": "'", '"': '"', "0": "\x00",
    "n": "\n", "r": "\r", "t": "\t", "Z": "\x1a", "b": "\b",
}


def _translate_literals(sql: str) -> str:
    """Rewrite MySQL single-quoted literals (backslash escapes) as sqlite
    literals (doubled-quote escapes), leaving everything outside strings
    untouched.  Identifier backticks become double quotes."""
    out: List[str] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "`":
            out.append('"')
            i += 1
        elif ch == "'":
            i += 1
            val: List[str] = []
            while i < n:
                c = sql[i]
                if c == "\\" and i + 1 < n:
                    val.append(_BACKSLASH_UNESCAPE.get(sql[i + 1], sql[i + 1]))
                    i += 2
                elif c == "'":
                    i += 1
                    break
                else:
                    val.append(c)
                    i += 1
            out.append("'" + "".join(val).replace("'", "''") + "'")
        else:
            out.append(ch)
            i += 1
    return "".join(out)


_VALUES_REF = re.compile(r"VALUES\((`?\w+`?)\)")
_UPSERT_CLAUSE = " ON DUPLICATE KEY UPDATE "


def _find_outside_literals(sql: str, needle: str) -> int:
    """Index of `needle` outside single-quoted literals, or -1 — a data
    value containing the upsert-clause text must not split the statement."""
    i, n = 0, len(sql)
    up = sql.upper()
    while i < n:
        c = sql[i]
        if c == "'":
            i += 1
            while i < n:
                if sql[i] == "\\" and i + 1 < n:
                    i += 2
                elif sql[i] == "'":
                    i += 1
                    break
                else:
                    i += 1
        elif up.startswith(needle, i):
            return i
        else:
            i += 1
    return -1


def _mysql_to_sqlite(sql: str) -> str:
    """The dialect shim for the statements MysqlModule emits."""
    m = _SHOW_COLS.match(sql.strip())
    if m:
        return f'PRAGMA table_info({m.group(1).replace("`", chr(34))})'
    # MySQL upsert -> sqlite upsert; VALUES(col) -> excluded.col.  A
    # partial-field update must keep the other columns (REPLACE would
    # null them — real MySQL preserves them).
    idx = _find_outside_literals(sql, _UPSERT_CLAUSE)
    if idx != -1:
        head = sql[:idx]
        tail = _VALUES_REF.sub(r"excluded.\1",
                               sql[idx + len(_UPSERT_CLAUSE):])
        sql = head + " ON CONFLICT(`id`) DO UPDATE SET " + tail
    return _translate_literals(sql)


class _MiniHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # noqa: D401
        srv: "MiniMysql" = self.server.mini  # type: ignore[attr-defined]
        with srv.conns_lock:
            srv.conns.add(self.request)
        try:
            self._serve(srv)
        finally:
            with srv.conns_lock:
                srv.conns.discard(self.request)

    def _serve(self, srv: "MiniMysql") -> None:
        io = _PacketIO(self.request)
        salt = b"0123456789abcdefghij"  # fixed 20-byte salt (deterministic)
        greeting = bytes([10]) + b"5.7.0-mini\x00"
        greeting += struct.pack("<I", 1)  # thread id
        greeting += salt[:8] + b"\x00"
        greeting += struct.pack("<H", _CAPS & 0xFFFF)
        greeting += bytes([33]) + struct.pack("<H", 2)  # charset, status
        greeting += struct.pack("<H", (_CAPS >> 16) & 0xFFFF)
        greeting += bytes([21]) + b"\x00" * 10
        greeting += salt[8:] + b"\x00"
        greeting += AUTH_PLUGIN + b"\x00"
        io.write(greeting)

        resp = io.read()
        off = 4 + 4 + 1 + 23  # caps, max packet, charset, zeros
        end = resp.index(b"\x00", off)
        user = resp[off:end].decode()
        off = end + 1
        alen = resp[off]
        off += 1
        auth = resp[off : off + alen]
        if srv.auth_switch:
            # exercise the MySQL-8 AuthSwitchRequest path: demand a
            # re-scramble against a fresh salt before accepting
            salt = b"jihgfedcba9876543210"
            io.write(b"\xfe" + AUTH_PLUGIN + b"\x00" + salt + b"\x00")
            auth = io.read()
        expected = scramble_native(srv.password, salt)
        if user != srv.user or auth != expected:
            io.write(
                b"\xff" + struct.pack("<H", 1045) + b"#28000"
                + b"Access denied"
            )
            return
        io.write(b"\x00\x00\x00\x02\x00\x00\x00")  # OK

        while True:
            io.reset_seq()
            try:
                cmd = io.read()
            except MysqlError:
                return
            if cmd[0] == COM_QUIT:
                return
            if cmd[0] == COM_PING:
                io.write(b"\x00\x00\x00\x02\x00\x00\x00")
                continue
            if cmd[0] != COM_QUERY:
                io.write(
                    b"\xff" + struct.pack("<H", 1047) + b"#08S01"
                    + b"unknown command"
                )
                continue
            self._run_query(io, srv, cmd[1:].decode("utf-8"))

    @staticmethod
    def _run_query(io: _PacketIO, srv: "MiniMysql", sql: str) -> None:
        try:
            # one shared database per server (data survives reconnects,
            # like a real mysqld), serialized by the server lock
            with srv.db_lock:
                cur = srv.db.execute(_mysql_to_sqlite(sql))
                rows = cur.fetchall()
                desc = cur.description
                srv.db.commit()
        except sqlite3.Error as e:
            io.write(
                b"\xff" + struct.pack("<H", 1064) + b"#42000"
                + str(e).encode()
            )
            return
        if desc is None:  # OK-only statement
            io.write(b"\x00\x00\x00\x02\x00\x00\x00")
            return
        if _SHOW_COLS.match(sql.strip()):
            # PRAGMA table_info rows -> SHOW COLUMNS shape (name first)
            rows = [(r[1],) for r in rows]
            names = ["Field"]
        else:
            names = [d[0] for d in desc]
        io.write(_lenc_int(len(names)))
        for n in names:
            nb = n.encode()
            io.write(
                _lenc_str(b"def") + _lenc_str(b"") * 3
                + _lenc_str(nb) + _lenc_str(nb)
                + bytes([0x0C]) + struct.pack("<HIBHB", 33, 255,
                                              TYPE_VAR_STRING, 0, 0)
                + b"\x00\x00"
            )
        eof = b"\xfe\x00\x00\x02\x00"
        io.write(eof)
        for row in rows:
            out = b""
            for v in row:
                if v is None:
                    out += b"\xfb"
                else:
                    if isinstance(v, bytes):
                        b = v
                    else:
                        b = str(v).encode("utf-8")
                    out += _lenc_str(b)
            io.write(out)
        io.write(eof)


class MiniMysql:
    """In-process MySQL wire server on a real TCP port (sqlite engine).

    The MiniRedis analog for SQL: real sockets, real packets, real
    native-password auth — so MysqlModule's bytes are validated without
    an external mysqld, and dev clusters can run a SQL endpoint with
    zero dependencies."""

    def __init__(self, user: str = "root", password: str = "",
                 host: str = "127.0.0.1", port: int = 0,
                 auth_switch: bool = False):
        self.user, self.password = user, password
        self.auth_switch = auth_switch
        self.db = sqlite3.connect(":memory:", check_same_thread=False)
        self.db_lock = threading.Lock()
        self.conns: set = set()
        self.conns_lock = threading.Lock()
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _MiniHandler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.mini = self  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        """Stop accepting AND sever live sessions — a dead server must
        look dead to connected clients (keepalive tests rely on it)."""
        self._srv.shutdown()
        self._srv.server_close()
        with self.conns_lock:
            for s in list(self.conns):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        with self.db_lock:
            self.db.close()
