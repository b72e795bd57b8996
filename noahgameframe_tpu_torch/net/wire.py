"""Minimal proto2 wire-format codec + the NF message set.

The reference speaks protobuf (`NFComm/NFMessageDefine/*.proto`) inside
its 6-byte frames; to stay byte-compatible with existing Unity/Cocos
clients without depending on protoc-generated code, this module
implements the protobuf wire format directly (varint / fixed32 /
length-delimited) and declares the handful of messages the framework
needs (`NFMsgBase.proto`, `NFMsgPreGame.proto`, `NFMsgShare.proto`).

Messages are declared with a tiny DSL:

    class Ident(Message):
        FIELDS = [(1, "svrid", "int64", 0), (2, "index", "int64", 0)]

Encoding skips fields equal to ``None``; decoding tolerates unknown
fields (skips them by wire type), matching protobuf semantics.

A copy of ``noahgameframe_tpu/net/wire.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple, Type

# ---------------------------------------------------------------- varint


def _enc_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v &= (1 << 64) - 1  # proto2 negative ints are 10-byte varints
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _dec_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed32(v: int) -> int:
    v &= (1 << 32) - 1
    return v - (1 << 32) if v >= (1 << 31) else v


_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")

# wire types
_WT_VARINT, _WT_64BIT, _WT_LEN, _WT_32BIT = 0, 1, 2, 5

_WIRE_TYPE = {
    "int32": _WT_VARINT,
    "int64": _WT_VARINT,
    "uint64": _WT_VARINT,
    "bool": _WT_VARINT,
    "enum": _WT_VARINT,
    "float": _WT_32BIT,
    "double": _WT_64BIT,
    "bytes": _WT_LEN,
    "string": _WT_LEN,
}


class Message:
    """Base class: subclasses declare FIELDS = [(tag, name, type, default)].

    type is one of the scalar names above, a Message subclass (embedded
    message), or ("repeated", inner) for repeated fields.
    """

    FIELDS: List[Tuple[int, str, Any, Any]] = []

    # populated lazily per-class
    _by_tag: Optional[Dict[int, Tuple[str, Any, bool]]] = None

    def __init__(self, **kw: Any) -> None:
        for _, name, ftype, default in self.FIELDS:
            if isinstance(ftype, tuple):  # repeated
                setattr(self, name, list(kw.get(name) or []))
            else:
                setattr(self, name, kw.get(name, default))
        bad = set(kw) - {f[1] for f in self.FIELDS}
        if bad:
            raise TypeError(f"{type(self).__name__}: unknown fields {bad}")

    # -------------------------------------------------------- encoding
    def encode(self) -> bytes:
        out = bytearray()
        for tag, name, ftype, _ in self.FIELDS:
            val = getattr(self, name)
            if isinstance(ftype, tuple):
                inner = ftype[1]
                for item in val:
                    _enc_field(out, tag, inner, item)
            elif val is not None:
                _enc_field(out, tag, ftype, val)
        return bytes(out)

    # -------------------------------------------------------- decoding
    @classmethod
    def decode(cls, data: bytes) -> "Message":
        if cls._by_tag is None or "_by_tag" not in cls.__dict__:
            cls._by_tag = {
                tag: (name, ftype, isinstance(ftype, tuple))
                for tag, name, ftype, _ in cls.FIELDS
            }
        msg = cls()
        off = 0
        n = len(data)
        while off < n:
            key, off = _dec_varint(data, off)
            tag, wt = key >> 3, key & 7
            spec = cls._by_tag.get(tag)
            if spec is None:
                off = _skip(data, off, wt)
                continue
            name, ftype, repeated = spec
            inner = ftype[1] if repeated else ftype
            val, off = _dec_field(data, off, wt, inner)
            if repeated:
                getattr(msg, name).append(val)
            else:
                setattr(msg, name, val)
        return msg

    # ------------------------------------------------------ niceties
    def __repr__(self) -> str:
        parts = ", ".join(
            f"{name}={getattr(self, name)!r}"
            for _, name, _, _ in self.FIELDS
            if getattr(self, name) not in (None, [])
        )
        return f"{type(self).__name__}({parts})"

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and all(
            getattr(self, f[1]) == getattr(other, f[1]) for f in self.FIELDS
        )


def _enc_field(out: bytearray, tag: int, ftype: Any, val: Any) -> None:
    if isinstance(ftype, type) and issubclass(ftype, Message):
        _enc_varint(out, tag << 3 | _WT_LEN)
        body = val.encode()
        _enc_varint(out, len(body))
        out.extend(body)
        return
    wt = _WIRE_TYPE[ftype]
    _enc_varint(out, tag << 3 | wt)
    if wt == _WT_VARINT:
        _enc_varint(out, int(val))
    elif wt == _WT_32BIT:
        out.extend(_F32.pack(val))
    elif wt == _WT_64BIT:
        out.extend(_F64.pack(val))
    else:
        if isinstance(val, str):
            val = val.encode("utf-8")
        _enc_varint(out, len(val))
        out.extend(val)


def _dec_field(buf: bytes, off: int, wt: int, ftype: Any) -> Tuple[Any, int]:
    if isinstance(ftype, type) and issubclass(ftype, Message):
        ln, off = _dec_varint(buf, off)
        return ftype.decode(buf[off : off + ln]), off + ln
    if wt == _WT_VARINT:
        v, off = _dec_varint(buf, off)
        if ftype in ("int32", "enum"):
            # protoc treats enum exactly like int32: negative values ride
            # as 10-byte two's-complement varints and truncate back
            v = _signed32(v)
        elif ftype == "int64":
            v = _signed64(v)
        elif ftype == "bool":
            v = bool(v)
        return v, off
    if wt == _WT_32BIT:
        return _F32.unpack_from(buf, off)[0], off + 4
    if wt == _WT_64BIT:
        return _F64.unpack_from(buf, off)[0], off + 8
    ln, off = _dec_varint(buf, off)
    return bytes(buf[off : off + ln]), off + ln


def _skip(buf: bytes, off: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, off = _dec_varint(buf, off)
        return off
    if wt == _WT_64BIT:
        return off + 8
    if wt == _WT_32BIT:
        return off + 4
    if wt == _WT_LEN:
        ln, off = _dec_varint(buf, off)
        return off + ln
    raise ValueError(f"unsupported wire type {wt}")


def R(inner: Any) -> Tuple[str, Any]:
    """repeated-field marker."""
    return ("repeated", inner)


# =====================================================================
# NFMsgBase.proto equivalents (field tags byte-compatible)
# =====================================================================


class Ident(Message):
    """128-bit GUID on the wire (`NFMsgBase.proto` Ident{svrid,index})."""

    FIELDS = [(1, "svrid", "int64", 0), (2, "index", "int64", 0)]


def ident_key(i: Optional["Ident"]) -> Tuple[int, int]:
    """Hashable identity of a wire Ident (routing-table key)."""
    return (i.svrid, i.index) if i is not None else (0, 0)


class Vector2(Message):
    FIELDS = [(1, "x", "float", 0.0), (2, "y", "float", 0.0)]


class Vector3(Message):
    FIELDS = [(1, "x", "float", 0.0), (2, "y", "float", 0.0), (3, "z", "float", 0.0)]


class MsgBase(Message):
    """The routing envelope every framed payload is wrapped in
    (`NFMsgBase.proto:281-287`)."""

    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "msg_data", "bytes", b""),
        (3, "player_client_list", R(Ident), None),
        (4, "hash_ident", Ident, None),
    ]


def scan_envelope_targets(body: bytes) -> List[Tuple[int, int]]:
    """Routing keys of a :class:`MsgBase` envelope, without decoding it.

    The proxy's scatter path (`ProxyRole._transpond`) needs only the
    client list to fan a frame out — not the (possibly megabyte)
    ``msg_data`` payload and not per-client ``Ident`` objects.  This
    walks the top-level fields once: ``msg_data`` is skipped in O(1)
    after its length varint, and each embedded Ident is decoded straight
    into its :func:`ident_key` tuple.  Returns the
    ``player_client_list`` keys, falling back to ``player_id`` when the
    list is absent (the same semantics ``_transpond`` applies to the
    decoded envelope).  Torn framing raises ``ValueError``/``IndexError``
    — callers fall back to the tolerant full decode.
    """
    targets: List[Tuple[int, int]] = []
    player: Optional[Tuple[int, int]] = None
    off, n = 0, len(body)
    while off < n:
        key, off = _dec_varint(body, off)
        tag, wt = key >> 3, key & 7
        if wt == _WT_LEN and tag in (1, 3):
            ln, off = _dec_varint(body, off)
            end = off + ln
            svrid = index = 0
            while off < end:
                ik, off = _dec_varint(body, off)
                itag, iwt = ik >> 3, ik & 7
                if iwt == _WT_VARINT and itag in (1, 2):
                    v, off = _dec_varint(body, off)
                    if itag == 1:
                        svrid = _signed64(v)
                    else:
                        index = _signed64(v)
                else:
                    off = _skip(body, off, iwt)
            off = end
            if tag == 3:
                targets.append((svrid, index))
            else:
                player = (svrid, index)
        else:
            off = _skip(body, off, wt)
    if targets:
        return targets
    return [player] if player is not None else []


class Position(Message):
    FIELDS = [(1, "x", "float", 0.0), (2, "y", "float", 0.0), (3, "z", "float", 0.0)]


# ---- property / record sync ----------------------------------------


class PropertyInt(Message):
    FIELDS = [(1, "property_name", "bytes", b""), (2, "data", "int64", 0)]


class PropertyFloat(Message):
    FIELDS = [(1, "property_name", "bytes", b""), (2, "data", "float", 0.0)]


class PropertyString(Message):
    FIELDS = [(1, "property_name", "bytes", b""), (2, "data", "bytes", b"")]


class PropertyObject(Message):
    FIELDS = [(1, "property_name", "bytes", b""), (2, "data", Ident, None)]


class PropertyVector2(Message):
    FIELDS = [(1, "property_name", "bytes", b""), (2, "data", Vector2, None)]


class PropertyVector3(Message):
    FIELDS = [(1, "property_name", "bytes", b""), (2, "data", Vector3, None)]


class ObjectPropertyList(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "property_int_list", R(PropertyInt), None),
        (3, "property_float_list", R(PropertyFloat), None),
        (4, "property_string_list", R(PropertyString), None),
        (5, "property_object_list", R(PropertyObject), None),
        (6, "property_vector2_list", R(PropertyVector2), None),
        (7, "property_vector3_list", R(PropertyVector3), None),
    ]


class ObjectPropertyInt(Message):
    FIELDS = [(1, "player_id", Ident, None), (2, "property_list", R(PropertyInt), None)]


class ObjectPropertyFloat(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "property_list", R(PropertyFloat), None),
    ]


class ObjectPropertyString(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "property_list", R(PropertyString), None),
    ]


class ObjectPropertyObject(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "property_list", R(PropertyObject), None),
    ]


class ObjectPropertyVector2(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "property_list", R(PropertyVector2), None),
    ]


class ObjectPropertyVector3(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "property_list", R(PropertyVector3), None),
    ]


class RecordInt(Message):
    FIELDS = [(1, "row", "int32", 0), (2, "col", "int32", 0), (3, "data", "int64", 0)]


class RecordFloat(Message):
    FIELDS = [(1, "row", "int32", 0), (2, "col", "int32", 0), (3, "data", "float", 0.0)]


class RecordString(Message):
    FIELDS = [(1, "row", "int32", 0), (2, "col", "int32", 0), (3, "data", "bytes", b"")]


class RecordObject(Message):
    FIELDS = [(1, "row", "int32", 0), (2, "col", "int32", 0), (3, "data", Ident, None)]


class RecordVector2(Message):
    FIELDS = [(1, "row", "int32", 0), (2, "col", "int32", 0), (3, "data", Vector2, None)]


class RecordVector3(Message):
    FIELDS = [(1, "row", "int32", 0), (2, "col", "int32", 0), (3, "data", Vector3, None)]


class RecordAddRowStruct(Message):
    FIELDS = [
        (1, "row", "int32", 0),
        (2, "record_int_list", R(RecordInt), None),
        (3, "record_float_list", R(RecordFloat), None),
        (4, "record_string_list", R(RecordString), None),
        (5, "record_object_list", R(RecordObject), None),
        (6, "record_vector2_list", R(RecordVector2), None),
        (7, "record_vector3_list", R(RecordVector3), None),
    ]


class ObjectRecordBase(Message):
    FIELDS = [
        (1, "record_name", "bytes", b""),
        (2, "row_struct", R(RecordAddRowStruct), None),
    ]


class ObjectRecordList(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_list", R(ObjectRecordBase), None),
    ]


# ---- per-change record sync (reference NFMsgBase.proto:183-251; the
# messages NFCGameServerNet_ServerModule::OnRecordEvent emits per op) ----


class ObjectRecordInt(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "property_list", R(RecordInt), None),
    ]


class ObjectRecordFloat(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "property_list", R(RecordFloat), None),
    ]


class ObjectRecordString(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "property_list", R(RecordString), None),
    ]


class ObjectRecordObject(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "property_list", R(RecordObject), None),
    ]


class ObjectRecordVector2(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "property_list", R(RecordVector2), None),
    ]


class ObjectRecordVector3(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "property_list", R(RecordVector3), None),
    ]


class ObjectRecordSwap(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "origin_record_name", "bytes", b""),
        (3, "target_record_name", "bytes", None),
        (4, "row_origin", "int32", 0),
        (5, "row_target", "int32", 0),
    ]


class ObjectRecordAddRow(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "row_data", R(RecordAddRowStruct), None),
    ]


class ObjectRecordRemove(Message):
    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "record_name", "bytes", b""),
        (3, "remove_row", R("int32"), None),
    ]


# =====================================================================
# NFMsgPreGame.proto equivalents — cluster control plane
# =====================================================================


class ServerInfoExt(Message):
    FIELDS = [(1, "key", R("bytes"), None), (2, "value", R("bytes"), None)]


class ServerInfoReport(Message):
    """10-second server heartbeat to Master (`NFMsgPreGame.proto:24-36`)."""

    FIELDS = [
        (1, "server_id", "int32", 0),
        (2, "server_name", "bytes", b""),
        (3, "server_ip", "bytes", b""),
        (4, "server_port", "int32", 0),
        (5, "server_max_online", "int32", 0),
        (6, "server_cur_count", "int32", 0),
        (7, "server_state", "enum", 1),
        (8, "server_type", "int32", 0),
        (9, "server_info_list_ext", ServerInfoExt, None),
    ]


class ServerInfoReportList(Message):
    FIELDS = [(1, "server_list", R(ServerInfoReport), None)]


class AckEventResult(Message):
    FIELDS = [
        (1, "event_code", "enum", 0),
        (2, "event_object", Ident, None),
        (3, "event_client", Ident, None),
    ]


class ReqAccountLogin(Message):
    FIELDS = [
        (2, "account", "bytes", b""),
        (3, "password", "bytes", b""),
        (4, "security_code", "bytes", b""),
        (5, "sign_buff", "bytes", b""),
        (6, "client_version", "int32", 0),
        (7, "login_mode", "int32", 0),
        (8, "client_ip", "int32", 0),
        (9, "client_mac", "int64", 0),
        (10, "device_info", "bytes", b""),
        (11, "extra_info", "bytes", b""),
        (12, "platform_type", "int32", None),
    ]


class ServerInfo(Message):
    FIELDS = [
        (1, "server_id", "int32", 0),
        (2, "name", "bytes", b""),
        (3, "wait_count", "int32", 0),
        (4, "status", "enum", 1),
    ]


class ReqServerList(Message):
    FIELDS = [(1, "type", "enum", 0)]


class AckServerList(Message):
    FIELDS = [(1, "type", "enum", 0), (2, "info", R(ServerInfo), None)]


class ReqConnectWorld(Message):
    FIELDS = [
        (1, "world_id", "int32", 0),
        (2, "account", "bytes", b""),
        (3, "sender", Ident, None),
        (4, "login_id", "int32", 0),
    ]


class AckConnectWorldResult(Message):
    FIELDS = [
        (1, "world_id", "int32", 0),
        (2, "sender", Ident, None),
        (3, "login_id", "int32", 0),
        (4, "account", "bytes", b""),
        (5, "world_ip", "bytes", b""),
        (6, "world_port", "int32", 0),
        (7, "world_key", "bytes", b""),
    ]


class ReqSelectServer(Message):
    FIELDS = [(1, "world_id", "int32", 0)]


class ReqRoleList(Message):
    FIELDS = [(1, "game_id", "int32", 0), (2, "account", "bytes", b"")]


class RoleLiteInfo(Message):
    FIELDS = [
        (1, "id", Ident, None),
        (2, "career", "int32", 0),
        (3, "sex", "int32", 0),
        (4, "race", "int32", 0),
        (5, "noob_name", "bytes", b""),
        (6, "game_id", "int32", 0),
        (7, "role_level", "int32", 0),
        (8, "delete_time", "int32", 0),
        (9, "reg_time", "int32", 0),
        (10, "last_offline_time", "int32", 0),
        (11, "last_offline_ip", "int32", 0),
        (12, "view_record", "bytes", b""),
    ]


class AckRoleLiteInfoList(Message):
    FIELDS = [(1, "char_data", R(RoleLiteInfo), None)]


class ReqCreateRole(Message):
    FIELDS = [
        (1, "account", "bytes", b""),
        (2, "career", "int32", 0),
        (3, "sex", "int32", 0),
        (4, "race", "int32", 0),
        (5, "noob_name", "bytes", b""),
        (6, "game_id", "int32", 0),
    ]


class ReqDeleteRole(Message):
    FIELDS = [
        (1, "account", "bytes", b""),
        (2, "name", "bytes", b""),
        (3, "game_id", "int32", 0),
    ]


class ServerHeartBeat(Message):
    FIELDS = [(1, "count", "int32", 0)]


class BatchPropertySync(Message):
    """Columnar sync (msg id ACK_BATCH_PROPERTY, outside the
    reference message space): every changed entity's value for ONE
    (class, property), packed as little-endian arrays — the wire mirror
    of the SoA store.  `ptype` is the DataType enum; `data` holds
    int32[n] / float32[n] / float32[n*3] depending on ptype; guids ride
    as i64 pairs.  Encoding stays valid proto2 (bytes fields), so
    unaware reference clients skip it cleanly by field type."""

    FIELDS = [
        (1, "class_name", "bytes", b""),
        (2, "property_name", "bytes", b""),
        (3, "ptype", "int32", 0),
        (4, "count", "int32", 0),
        (5, "svrid", "bytes", b""),  # i64le[n]
        (6, "index", "bytes", b""),  # i64le[n]
        (7, "data", "bytes", b""),
    ]


class InterestPosSync(Message):
    """Per-session position stream (msg id ACK_INTEREST_POS):
    ONLY the entities inside this client's interest radius, positions
    quantized to u16 over the scene extent (`scale` = extent / 65535 —
    multiply back on the client).  Replaces group-wide Position fan-out
    when the game role runs with an interest radius; guids ride as i64
    pairs like BatchPropertySync.  qpos holds u16le[n*3].

    The stream is a per-session DELTA (only entities this session hasn't
    seen at this quantized position), so leave-view must be explicit:
    `gone_svrid`/`gone_index` list the entities that dropped out of this
    observer's radius (or died) since the last message — the client
    despawns them (the reference's OnObjectListLeave)."""

    FIELDS = [
        (1, "scale", "float", 0.0),
        (2, "count", "int32", 0),
        (3, "svrid", "bytes", b""),  # i64le[n]
        (4, "index", "bytes", b""),  # i64le[n]
        (5, "qpos", "bytes", b""),  # u16le[n*3]
        (6, "gone_svrid", "bytes", b""),  # i64le[m]
        (7, "gone_index", "bytes", b""),  # i64le[m]
    ]


class ReqSwitchServer(Message):
    """Cross-game-server player switch request
    (`NFMsgShare.proto:527-536`, EGMI_REQSWICHSERVER) — game A asks game
    B (via World) to take over a player."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "self_serverid", "int64", 0),
        (3, "target_serverid", "int64", 0),
        (4, "gate_serverid", "int64", 0),
        (5, "scene_id", "int64", 0),
        (6, "client_id", Ident, None),
        (7, "group_id", "int64", 0),
    ]


class AckSwitchServer(Message):
    """Switch completed on the target (`NFMsgShare.proto:539-545`,
    EGMI_ACKSWICHSERVER) — game A destroys its copy on receipt."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "self_serverid", "int64", 0),
        (3, "target_serverid", "int64", 0),
        (4, "gate_serverid", "int64", 0),
    ]


class SwitchServerData(Message):
    """Companion to ReqSwitchServer (msg id
    SWITCH_SERVER_DATA): the player's serialized save-flag state
    (persist.codec snapshot blob) plus the identity keys, so the target
    game re-homes the player without a shared database — the reference
    relies on both games loading the same DB row."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "account", "bytes", b""),
        (3, "name", "bytes", b""),
        (4, "blob", "bytes", b""),
        (5, "target_serverid", "int64", 0),
    ]


class ReqSetFightHero(Message):
    """Pick the battle line-up hero (`NFMsgShare.proto:481-486`,
    EGEC_REQ_SET_FIGHT_HERO).  Heroes are row-identified here, so the
    hero's PlayerHero record row rides `heroid.index` (svrid 0)."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "heroid", Ident, None),
        (3, "fight_pos", "int32", 0),
    ]


class RoleOnlineNotify(Message):
    """Game → World: a player came online (player guid rides the MsgBase
    envelope; `NFMsgPreGame.proto` RoleOnlineNotify)."""

    FIELDS = [(1, "guild", Ident, None)]


class RoleOfflineNotify(Message):
    FIELDS = [(1, "guild", Ident, None)]


class SwitchNotice(Message):
    """Proxy → client (msg id ACK_SWITCH_NOTICE): the bound game died.
    An extension: the reference lets orphaned clients time out; we tell
    them what is happening (re-home in flight / retry later / parked
    frames dropped).  Codes in :class:`net.defines.SwitchNoticeCode`."""

    FIELDS = [
        (1, "code", "int32", 0),
        (2, "target_serverid", "int64", 0),
        (3, "retry_after_ms", "int64", 0),
    ]


class SessionBindNotify(Message):
    """Game → world (msg id SESSION_BIND_NOTIFY): sidecar to
    ACK_ONLINE_NOTIFY carrying the session metadata the world's failover
    driver needs to re-home this player if the owning game dies without
    ever being asked — account/name (the durable save identity),
    client ident (the proxy-side session key), scene/group, and the
    exact persist key the player's blob lives under."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "account", "bytes", b""),
        (3, "name", "bytes", b""),
        (4, "client_id", Ident, None),
        (5, "scene_id", "int64", 0),
        (6, "group_id", "int64", 0),
        (7, "save_key", "bytes", b""),
        (8, "game_id", "int64", 0),
    ]


class SwitchRefused(Message):
    """Target game → world (msg id ACK_SWITCH_REFUSED): a staged
    switch-in could not be admitted (capacity, torn blob).  The
    reference's AckSwitchServer has no failure leg — extending it would
    break protoc byte-compat — so refusal rides its own message and the
    failover driver retries a different survivor."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "self_serverid", "int64", 0),
        (3, "target_serverid", "int64", 0),
        (4, "result", "int32", 0),
    ]


# =====================================================================
# NFMsgShare.proto equivalents — in-game
# =====================================================================


class ReqEnterGameServer(Message):
    FIELDS = [
        (1, "id", Ident, None),
        (2, "account", "bytes", b""),
        (3, "game_id", "int32", 0),
        (4, "name", "bytes", b""),
    ]


class PlayerEntryInfo(Message):
    FIELDS = [
        (1, "object_guid", Ident, None),
        (2, "x", "float", 0.0),
        (3, "y", "float", 0.0),
        (4, "z", "float", 0.0),
        (5, "career_type", "int32", 0),
        (6, "player_state", "int32", 0),
        (7, "config_id", "bytes", b""),
        (8, "scene_id", "int32", 0),
        (9, "class_id", "bytes", b""),
    ]


class AckPlayerEntryList(Message):
    FIELDS = [(1, "object_list", R(PlayerEntryInfo), None)]


class AckPlayerLeaveList(Message):
    FIELDS = [(1, "object_list", R(Ident), None)]


class ReqAckPlayerMove(Message):
    FIELDS = [
        (1, "mover", Ident, None),
        (2, "move_type", "int32", 0),
        (3, "target_pos", R(Position), None),
        (4, "source_pos", R(Position), None),
    ]


class ChatContainer(Message):
    FIELDS = [(2, "container_type", "int32", 0), (3, "data_info", "bytes", b"")]


class ReqAckPlayerChat(Message):
    FIELDS = [
        (1, "chat_id", Ident, None),
        (2, "chat_type", "enum", 0),
        (3, "chat_info", "bytes", b""),
        (4, "chat_name", "bytes", b""),
        (5, "target_id", Ident, None),
        (6, "container_data", R(ChatContainer), None),
    ]


class EffectData(Message):
    FIELDS = [
        (1, "effect_ident", Ident, None),
        (2, "effect_value", "int32", 0),
        (3, "effect_rlt", "enum", 0),
    ]


class ReqAckUseSkill(Message):
    FIELDS = [
        (1, "user", Ident, None),
        (2, "skill_id", "bytes", b""),
        (3, "now_pos", Position, None),
        (4, "tar_pos", Position, None),
        (5, "use_index", "int32", 0),
        (6, "effect_data", R(EffectData), None),
    ]


class ReqAckSwapScene(Message):
    FIELDS = [
        (1, "transfer_type", "enum", 0),
        (2, "scene_id", "int32", 0),
        (3, "line_id", "int32", 0),
        (4, "x", "float", None),
        (5, "y", "float", None),
        (6, "z", "float", None),
    ]


class ItemStruct(Message):
    """`NFMsgShare.proto:155-159` — config id + count."""

    FIELDS = [
        (1, "item_id", "string", b""),
        (2, "item_count", "int32", 0),
    ]


class ReqAckUseItem(Message):
    """Use-item request/ack (`NFMsgShare.proto:128-135`,
    EGMI_REQ_ITEM_OBJECT).  Items are ConfigID-keyed stackables here, so
    `item.item_id` names what to use; family-specific targets (hero row,
    equip row) ride `targetid.index` with `targetid.svrid == 1` (the
    game role's ROW_TARGET_SVRID tag — row 0 is a valid record row, and
    a required-field protoc client sends a ZEROED ident when it has no
    target, so the index alone cannot discriminate)."""

    FIELDS = [
        (1, "user", Ident, None),
        (2, "item_guid", Ident, None),
        (3, "effect_data", R(EffectData), None),
        (4, "item", ItemStruct, None),
        (5, "targetid", Ident, None),
    ]


class ReqWearEquip(Message):
    """`NFMsgShare.proto:489-495`, EGEC_WEAR_EQUIP — the BagEquipList
    row rides `equipid.index` (row-identified equips)."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "equipid", Ident, None),
        (3, "target_id", Ident, None),
    ]


class TakeOffEquip(Message):
    """`NFMsgShare.proto:498-503`, EGEC_TAKEOFF_EQUIP."""

    FIELDS = [
        (1, "selfid", Ident, None),
        (2, "equipid", Ident, None),
        (3, "target_id", Ident, None),
    ]


class ReqAcceptTask(Message):
    """`NFMsgShare.proto:183-186`, EGMI_REQ_ACCEPT_TASK."""

    FIELDS = [(1, "task_id", "bytes", b"")]


class ReqCompeleteTask(Message):
    """`NFMsgShare.proto:188-191` (reference's own spelling),
    EGMI_REQ_COMPELETE_TASK — claim the award of a DONE task."""

    FIELDS = [(1, "task_id", "bytes", b"")]


class TeammemberInfo(Message):
    """`NFMsgShare.proto:555-562`."""

    FIELDS = [
        (1, "player_id", Ident, None),
        (2, "name", "string", b""),
        (3, "nLevel", "int32", 0),
        (4, "job", "int32", 0),
        (5, "HeadIcon", "string", b""),
    ]


class TeamInfo(Message):
    """`NFMsgShare.proto:548-553`."""

    FIELDS = [
        (1, "team_id", Ident, None),
        (2, "captain_id", Ident, None),
        (3, "teammemberInfo", R(TeammemberInfo), None),
    ]


class ReqAckCreateTeam(Message):
    """`NFMsgShare.proto:566-570`, EGMI_REQ/ACK_CREATE_TEAM."""

    FIELDS = [
        (1, "team_id", Ident, None),
        (2, "xTeamInfo", TeamInfo, None),
    ]


class ReqAckJoinTeam(Message):
    FIELDS = [
        (1, "team_id", Ident, None),
        (2, "xTeamInfo", TeamInfo, None),
    ]


class ReqAckLeaveTeam(Message):
    FIELDS = [
        (1, "team_id", Ident, None),
        (2, "xTeamInfo", TeamInfo, None),
    ]


class ReqAckOprTeamMember(Message):
    """`NFMsgShare.proto:591-612`, EGMI_REQ/ACK_OPRMEMBER_TEAM —
    captain member operations (KICK etc.)."""

    FIELDS = [
        (1, "team_id", Ident, None),
        (2, "member_id", Ident, None),
        (3, "type", "enum", 0),
        (4, "xTeamInfo", TeamInfo, None),
    ]


class ReqAckCreateGuild(Message):
    """`NFMsgShare.proto:235-239`, EGMI_REQ/ACK_CREATE_GUILD."""

    FIELDS = [
        (1, "guild_id", Ident, None),
        (2, "guild_name", "string", b""),
    ]


class ReqAckJoinGuild(Message):
    FIELDS = [
        (1, "guild_id", Ident, None),
        (2, "guild_name", "string", b""),
    ]


class ReqAckLeaveGuild(Message):
    FIELDS = [
        (1, "guild_id", Ident, None),
        (2, "guild_name", "string", b""),
    ]


class ReqSearchGuild(Message):
    """`NFMsgShare.proto:241-244`, EGMI_REQ_SEARCH_GUILD."""

    FIELDS = [(1, "guild_name", "string", b"")]


class ReqCommand(Message):
    """GM command (`NFMsgBase.proto:296-312`, EGMI_REQ_CMD_NORMAL):
    EGCT_MODIY_PROPERTY / MODIY_ITEM / CREATE_OBJECT / ADD_ROLE_EXP."""

    FIELDS = [
        (1, "control_id", Ident, None),
        (2, "command_id", "enum", 0),
        (3, "command_str_value", "bytes", None),
        (4, "command_value_int", "int64", None),
        (5, "command_value_float", "double", None),
        (6, "command_value_str", "bytes", None),
        (7, "command_value_object", Ident, None),
        (8, "row", "int32", None),
    ]


class PVPRoomInfo(Message):
    """`NFMsgShare.proto:772-784`."""

    FIELDS = [
        (1, "nCellStatus", "int32", 0),
        (2, "RoomID", Ident, None),
        (3, "nPVPMode", "int32", 0),
        (4, "nPVPGrade", "int32", 0),
        (5, "MaxPalyer", "int32", 0),
        (6, "xRedPlayer", R(Ident), None),
        (7, "xBluePlayer", R(Ident), None),
        (8, "serverid", "int64", None),
        (9, "SceneID", "int64", None),
        (10, "groupID", "int64", None),
    ]


class ReqPVPApplyMatch(Message):
    """`NFMsgShare.proto:787-801`, EGMI_REQ_PVPAPPLYMACTCH."""

    FIELDS = [
        (1, "self_id", Ident, None),
        (2, "nPVPMode", "int32", 0),
        (3, "score", "int64", None),
        (4, "ApplyType", "int32", 0),
        (5, "team_id", Ident, None),
    ]


class AckPVPApplyMatch(Message):
    """`NFMsgShare.proto:803-810`."""

    FIELDS = [
        (1, "self_id", Ident, None),
        (2, "xRoomInfo", PVPRoomInfo, None),
        (3, "ApplyType", "int32", 0),
        (4, "nResult", "int32", 0),
    ]


class ReqCreatePVPEctype(Message):
    """`NFMsgShare.proto:812-817`, EGMI_REQ_CREATEPVPECTYPE."""

    FIELDS = [
        (1, "self_id", Ident, None),
        (2, "xRoomInfo", PVPRoomInfo, None),
    ]


class AckCreatePVPEctype(Message):
    """`NFMsgShare.proto:819-825`."""

    FIELDS = [
        (1, "self_id", Ident, None),
        (2, "xRoomInfo", PVPRoomInfo, None),
        (3, "ApplyType", "int32", 0),
    ]


class SearchGuildObject(Message):
    """Nested result row of AckSearchGuild (`NFMsgShare.proto:247-257`)."""

    FIELDS = [
        (1, "guild_ID", Ident, None),
        (2, "guild_name", "string", b""),
        (3, "guild_icon", "string", b""),
        (4, "guild_member_count", "int32", 0),
        (5, "guild_member_max_count", "int32", 0),
        (6, "guild_honor", "int32", 0),
        (7, "guild_rank", "int32", 0),
    ]


class AckSearchGuild(Message):
    FIELDS = [(1, "guild_list", R(SearchGuildObject), None)]


def wrap(msg: Message, player_id: Optional[Ident] = None, clients=None,
         hash_ident: Optional[Ident] = None) -> bytes:
    """Encode a payload inside the MsgBase envelope (SendMsgPB path,
    `NFINetModule.h:316-471`)."""
    return MsgBase(
        player_id=player_id or Ident(),
        msg_data=msg.encode(),
        player_client_list=clients or [],
        hash_ident=hash_ident,
    ).encode()


def unwrap(data: bytes, payload_cls: Optional[Type[Message]] = None):
    """Decode a MsgBase envelope; optionally decode its payload too
    (ReceivePB path, `NFINetModule.h:263-300`)."""
    base = MsgBase.decode(data)
    if payload_cls is None:
        return base, None
    return base, payload_cls.decode(base.msg_data)
