"""The remaining reference proto families as wire.py message classes.

net/wire.py carries the core protocol (NFMsgBase / NFMsgPreGame /
NFMsgShare subset the five roles speak).  This module completes the wire
surface with the other reference families so clients and middleware can
exchange every message the reference defines
(the reference's NFComm/NFMessageDefine/):

- NFMsgMysql.proto  — async-MySQL actor request/server-info packs
  (shipped to NFCMysqlComponent workers, NFCAsyMysqlModule.cpp:558-599).
- NFMsgURl.proto    — async HTTP-request pack.
- NFSLGDefine.proto — SLG building/army messages + their enum spaces.
- NFFleetingDefine.proto — client-side FX/animation event tracks
  (package NFFS; nested event messages are flattened to module level
  under their proto nested names, e.g. BulletEvents.Bullet -> Bullet).

Every class here is cross-validated byte-for-byte against
protoc-generated code in tests/test_wire_protoc.py, exactly like the
core set.  Field names keep the reference's spelling where it is legal
Python, so generated docs line up with the .proto sources.

A copy of ``noahgameframe_tpu/net/wire_families.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum

from .wire import Ident, Message, R

# ---------------------------------------------------------------- NFMsgMysql


class PackMysqlParam(Message):
    FIELDS = [
        (1, "strRecordName", "bytes", b""),
        (2, "strKey", "bytes", b""),
        (3, "fieldVecList", R("bytes"), None),
        (4, "valueVecList", R("bytes"), None),
        (5, "bExit", "int64", 0),
        (6, "nreqid", "int64", 0),
        (7, "nRet", "int64", 0),
        (8, "eType", "int64", 0),
    ]


class PackMysqlServerInfo(Message):
    FIELDS = [
        (1, "nRconnectTime", "int64", 0),
        (2, "nRconneCount", "int64", 0),
        (3, "nPort", "int64", 0),
        (4, "strDBName", "bytes", b""),
        (5, "strDnsIp", "bytes", b""),
        (6, "strDBUser", "bytes", b""),
        (7, "strDBPwd", "bytes", b""),
        (8, "nServerID", "int64", 0),
    ]


# ----------------------------------------------------------------- NFMsgURl


class PackSURLParam(Message):
    FIELDS = [
        (1, "strUrl", "bytes", b""),
        (2, "strGetParams", "bytes", b""),
        (3, "strBodyData", "bytes", b""),
        (4, "strCookies", "bytes", b""),
        (5, "fTimeOutSec", "double", 0.0),
        (6, "strRsp", "bytes", b""),
        (7, "nRet", "int64", 0),
        (8, "nReqID", "int64", 0),
    ]


# -------------------------------------------------------------- NFSLGDefine


# single-source enums: the gameplay layer owns them; the wire layer
# re-exports so both sides can never diverge on values that ride the wire
from ..game.defines import SLGBuildingState, SLGBuildingType  # noqa: F401,E402


class SLGFuncType(enum.IntEnum):
    INFO = 0
    BOOST = 1
    LVLUP = 2
    CREATE_SOLDER = 3
    CREATE_SPEEL = 4
    RESEARCH = 5
    COLLECT_GOLD = 6
    COLLECT_STONE = 7
    COLLECT_STEEL = 8
    COLLECT_DIAMOND = 9
    SELL = 10
    REPAIR = 11
    CANCEL = 12
    FINISH = 13


class ReqAckBuyObjectFormShop(Message):
    FIELDS = [
        (1, "config_id", "string", b""),
        (2, "x", "float", 0.0),
        (3, "y", "float", 0.0),
        (4, "z", "float", 0.0),
        (5, "Shop_id", "string", b""),
    ]


class ReqAckMoveBuildObject(Message):
    FIELDS = [
        (1, "row", "int32", None),
        (2, "object_guid", Ident, None),
        (3, "x", "float", 0.0),
        (4, "y", "float", 0.0),
        (5, "z", "float", 0.0),
    ]


class ReqUpBuildLv(Message):
    FIELDS = [
        (1, "row", "int32", None),
        (2, "object_guid", Ident, None),
    ]


class ReqCreateItem(Message):
    FIELDS = [
        (1, "row", "int32", None),
        (2, "object_guid", Ident, None),
        (3, "config_id", "string", b""),
        (4, "count", "int32", 0),
    ]


class ReqBuildOperate(Message):
    FIELDS = [
        (1, "row", "int32", None),
        (2, "object_guid", Ident, None),
        (3, "functype", "enum", 0),
    ]


# --------------------------------------------------------- NFFleetingDefine
# Client FX/animation event tracks (package NFFS).  The proto nests the
# per-event messages; here each nested message is a module-level class
# under its nested name.


class FSVector3(Message):
    FIELDS = [
        (1, "x", "float", 0.0),
        (2, "y", "float", 0.0),
        (3, "z", "float", 0.0),
    ]


class Suwayyah(Message):
    FIELDS = [
        (1, "EventType", "enum", 0),
        (2, "EventTime", "float", 0.0),
        (3, "EndTime", "float", 0.0),
        (4, "DamageRang", "float", 0.0),
        (5, "BackHeroDis", "float", 0.0),
        (6, "BackNpcDis", "float", 0.0),
        (7, "BeAttackParticle", "string", b""),
        (8, "MethodCall", "string", b""),
        (9, "MethodParam", "string", b""),
        (10, "TargetMethodCall", "string", b""),
        (11, "TargetMethodParam", "string", b""),
    ]


class SuwayyahEvents(Message):
    FIELDS = [(1, "xSuwayyahList", R(Suwayyah), None)]


class TacheBomp(Message):
    FIELDS = [
        (1, "BompTime", "float", 0.0),
        (2, "BompRang", "float", 0.0),
        (3, "BompPrefabPath", "string", b""),
        (4, "BeAttackParticle", "string", b""),
        (5, "BackNpcDis", "float", 0.0),
        (6, "BackHeroDis", "float", 0.0),
        (7, "MethodCall", "string", b""),
        (8, "MethodParam", "string", b""),
        (9, "TargetMethodCall", "string", b""),
        (10, "TargetMethodParam", "string", b""),
    ]


class Bullet(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "Speed", "float", 0.0),
        (4, "MaxDis", "float", 0.0),
        (5, "BulletRang", "float", 0.0),
        (6, "BulletBackType", "enum", 0),
        (7, "BackHeroDis", "float", 0.0),
        (8, "BackNpcDis", "float", 0.0),
        (9, "TacheDetroy", "int32", 0),
        (10, "BeAttackParticle", "string", b""),
        (11, "FireTacheName", "string", b""),
        (12, "FireTacheOffest", FSVector3, None),
        (13, "BulletPrefabPath", "string", b""),
        (14, "MethodCall", "string", b""),
        (15, "MethodParam", "string", b""),
        (16, "TargetMethodCall", "string", b""),
        (17, "TargetMethodParam", "string", b""),
        (18, "Bomp", R(TacheBomp), None),
    ]


class BulletEvents(Message):
    FIELDS = [(1, "xBulletList", R(Bullet), None)]


class Move(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "MoveDis", "float", 0.0),
        (4, "MoveTime", "float", 0.0),
        (5, "MethodCall", "string", b""),
        (6, "MethodParam", "string", b""),
    ]


class AnimatorMoves(Message):
    FIELDS = [(1, "xMoveList", R(Move), None)]


class Camera(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "AmountParam", FSVector3, None),
        (4, "ShakeTime", "float", 0.0),
        (5, "MethodCall", "string", b""),
        (6, "MethodParam", "string", b""),
    ]


class CameraControlEvents(Message):
    FIELDS = [(1, "xCameraList", R(Camera), None)]


class Particle(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (3, "Rotation", "enum", 0),
        (4, "ParticlePath", "string", b""),
        (5, "TargetTacheName", "string", b""),
        (6, "TargetTacheOffest", FSVector3, None),
        (7, "CastToSurface", "int32", 0),
        (8, "BindTarget", "int32", 0),
        (9, "DestroyTime", "float", 0.0),
        (10, "MethodCall", "string", b""),
        (11, "MethodParam", "string", b""),
    ]


class ParticleEvents(Message):
    FIELDS = [(1, "xParticleList", R(Particle), None)]


class Enable(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "TargetName", "string", b""),
        (4, "MethodCall", "string", b""),
        (5, "MethodParam", "string", b""),
    ]


class EnableEvents(Message):
    FIELDS = [(1, "xEnableList", R(Enable), None)]


class Trail(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "TargetName", "string", b""),
        (4, "MethodCall", "string", b""),
        (5, "MethodParam", "string", b""),
    ]


class TrailEvents(Message):
    FIELDS = [(1, "xTrailList", R(Trail), None)]


class Audio(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "AudioName", "string", b""),
        (4, "MethodCall", "string", b""),
        (5, "MethodParam", "string", b""),
    ]


class AudioEvents(Message):
    FIELDS = [(1, "xAudioList", R(Audio), None)]


class Speed(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "SpeedValue", "float", 0.0),
    ]


class GlobalSpeeds(Message):
    FIELDS = [(1, "xSpeedList", R(Speed), None)]


class Fly(Message):
    FIELDS = [
        (1, "EventTime", "float", 0.0),
        (2, "EventType", "enum", 0),
        (3, "MoveDis", "float", 0.0),
        (4, "MoveTime", "float", 0.0),
        (5, "MoveTopDis", "float", 0.0),
        (6, "MethodCall", "string", b""),
        (7, "MethodParam", "string", b""),
    ]


class AnimatorFlys(Message):
    FIELDS = [(1, "xFlyList", R(Fly), None)]
