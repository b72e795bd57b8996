"""Protocol constants: message-ID space, server types/states, event codes.

Byte/value-compatible with the reference's `NFDefine.proto` EGameMsgID
(`NFComm/NFMessageDefine/NFDefine.proto:61-200`), the server-type enum
(`NFComm/NFPluginModule/NFINetModule.h:22-32`) and EServerState
(`NFMsgPreGame.proto:9-16`).

A copy of ``noahgameframe_tpu/net/defines.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum


class ServerType(enum.IntEnum):
    NONE = 0
    REDIS = 1
    MYSQL = 2
    MASTER = 3
    LOGIN = 4
    PROXY = 5
    GAME = 6
    WORLD = 7


class ServerState(enum.IntEnum):
    CRASH = 0
    NORMAL = 1  # "EST_NARMAL" in the reference
    BUSY = 2
    FIRE = 3
    MAINTEN = 4


class SwitchNoticeCode(enum.IntEnum):
    """ACK_SWITCH_NOTICE codes (an extension; no reference equivalent —
    the reference lets orphaned clients time out on a dead game)."""

    REHOMING = 1  # bound game died; failover in progress, frames parked
    BUSY = 2      # no survivor has capacity right now; retry after delay
    DROPPED = 3   # parked frames were dropped (deadline or overflow)


class EventCode(enum.IntEnum):
    SUCCESS = 0
    UNKNOWN_ERROR = 1
    ACCOUNT_EXIST = 2
    ACCOUNTPWD_INVALID = 3
    ACCOUNT_USING = 4
    ACCOUNT_LOCKED = 5
    ACCOUNT_SUCCESS = 6
    VERIFY_KEY_SUCCESS = 7
    VERIFY_KEY_FAIL = 8
    SELECTSERVER_SUCCESS = 9
    SELECTSERVER_FAIL = 10
    CHARACTER_EXIST = 110
    CHARACTER_NUMOUT = 112
    CHARACTER_INVALID = 113
    CHARACTER_NOTEXIST = 114
    NOT_ONLINE = 118
    ENTER_GAME_SUCCESS = 144


class MsgID(enum.IntEnum):
    """EGameMsgID — the shared message-ID space for every link."""

    UNKNOWN = 0
    EVENT_RESULT = 1
    EVENT_TRANSPOND = 2
    CLOSE_SOCKET = 3

    # master <-> world / login registration
    MTL_WORLD_REGISTERED = 10
    MTL_WORLD_UNREGISTERED = 11
    MTL_WORLD_REFRESH = 12
    LTM_LOGIN_REGISTERED = 20
    LTM_LOGIN_UNREGISTERED = 21
    LTM_LOGIN_REFRESH = 22
    PTWG_PROXY_REGISTERED = 30
    PTWG_PROXY_UNREGISTERED = 31
    PTWG_PROXY_REFRESH = 32
    GTW_GAME_REGISTERED = 40
    GTW_GAME_UNREGISTERED = 41
    GTW_GAME_REFRESH = 42

    STS_NET_INFO = 50
    STS_SERVER_REPORT = 90
    STS_HEART_BEAT = 100

    # login flow
    REQ_LOGIN = 101
    ACK_LOGIN = 102
    REQ_LOGOUT = 103
    REQ_WORLD_LIST = 110
    ACK_WORLD_LIST = 111
    REQ_CONNECT_WORLD = 112
    ACK_CONNECT_WORLD = 113
    REQ_KICK_CLIENT_INWORLD = 114
    REQ_CONNECT_KEY = 120
    ACK_CONNECT_KEY = 122

    # role flow
    REQ_SELECT_SERVER = 130
    ACK_SELECT_SERVER = 131
    REQ_ROLE_LIST = 132
    ACK_ROLE_LIST = 133
    REQ_CREATE_ROLE = 134
    REQ_DELETE_ROLE = 135
    REQ_RECOVER_ROLE = 136

    # game entry
    REQ_ENTER_GAME = 150
    ACK_ENTER_GAME = 151
    REQ_LEAVE_GAME = 152
    ACK_LEAVE_GAME = 153
    REQ_SWAP_GAME = 154
    REQ_SWAP_SCENE = 155
    ACK_SWAP_SCENE = 156

    # object sync
    ACK_OBJECT_ENTRY = 200
    ACK_OBJECT_LEAVE = 201
    ACK_OBJECT_PROPERTY_ENTRY = 202
    ACK_OBJECT_RECORD_ENTRY = 203
    ACK_PROPERTY_INT = 210
    ACK_PROPERTY_FLOAT = 211
    ACK_PROPERTY_STRING = 212
    ACK_PROPERTY_OBJECT = 214
    ACK_PROPERTY_VECTOR2 = 215
    ACK_PROPERTY_VECTOR3 = 216
    ACK_ADD_ROW = 220
    ACK_REMOVE_ROW = 221
    ACK_SWAP_ROW = 222
    ACK_RECORD_INT = 223
    ACK_RECORD_FLOAT = 224
    ACK_RECORD_STRING = 226
    ACK_RECORD_OBJECT = 227
    ACK_RECORD_VECTOR2 = 228
    ACK_RECORD_VECTOR3 = 229
    ACK_RECORD_CLEAR = 250
    ACK_RECORD_SORT = 251
    # framework extension (outside the reference EGameMsgID space):
    # columnar batch property sync — one message carries every changed
    # entity's value for one (class, property) as packed arrays, replacing
    # tens of thousands of per-entity messages per frame at 100k+ scale
    ACK_BATCH_PROPERTY = 8001
    # per-session interest-filtered position stream (u16-quantized):
    # each client receives only entities within its interest radius
    ACK_INTEREST_POS = 8002
    # serialized-player companion to REQ_SWITCH_SERVER (re-home without
    # a shared database; game -> world -> target game)
    SWITCH_SERVER_DATA = 8003
    # frame observatory: sampled trace context riding the
    # served path game -> proxy -> client, acked back client -> proxy ->
    # game.  Pure observability — both ids are excluded from the flight
    # recorder journal so replays stay bit-identical with tracing on.
    FRAME_TRACE = 8004
    FRAME_TRACE_ACK = 8005
    # session failover: proxy -> client notice that the bound
    # game died and the session is being re-homed (or was given up on) —
    # clients see an explicit BUSY/retry-after instead of a silent stall
    ACK_SWITCH_NOTICE = 8006
    # game -> world sidecar to ACK_ONLINE_NOTIFY carrying the session
    # metadata (account/name/client ident/scene/group/save key) the
    # world's failover driver needs to re-home the player after the
    # owning game dies without being asked
    SESSION_BIND_NOTIFY = 8007
    # target game -> world: staged switch-in refused (capacity / torn
    # blob) — the reference AckSwitchServer has no failure leg
    ACK_SWITCH_REFUSED = 8008

    # in-game actions
    REQ_MOVE = 1230
    ACK_MOVE = 1231
    REQ_MOVE_IMMUNE = 1232
    ACK_MOVE_IMMUNE = 1233
    REQ_SKILL_OBJECTX = 1240
    ACK_SKILL_OBJECTX = 1241
    REQ_SKILL_POS = 1242
    ACK_SKILL_POS = 1243
    REQ_ITEM_OBJECT = 1244
    ACK_ITEM_OBJECT = 1245
    REQ_CHAT = 1250
    ACK_CHAT = 1251
    REQ_SALE_ITEM = 1252
    REQ_SPLIT_ITEM = 1253
    REQ_PRODUCE_ITEM = 1254
    REQ_PICK_ITEM = 1255
    REQ_ACCEPT_TASK = 1256
    REQ_COMPLETE_TASK = 1257
    # guild ops (NFDefine.proto:184-193)
    REQ_CREATE_GUILD = 1300
    ACK_CREATE_GUILD = 1301
    REQ_JOIN_GUILD = 1302
    ACK_JOIN_GUILD = 1303
    REQ_LEAVE_GUILD = 1304
    ACK_LEAVE_GUILD = 1305
    REQ_SEARCH_GUILD = 1308
    ACK_SEARCH_GUILD = 1309
    REQ_SET_FIGHT_HERO = 1508  # EGEC_REQ_SET_FIGHT_HERO
    WEAR_EQUIP = 1509  # EGEC_WEAR_EQUIP
    TAKEOFF_EQUIP = 1510  # EGEC_TAKEOFF_EQUIP
    # cross-game-server switch (NFDefine.proto:268-269)
    REQ_SWITCH_SERVER = 1840  # EGMI_REQSWICHSERVER
    ACK_SWITCH_SERVER = 1841  # EGMI_ACKSWICHSERVER
    # teams (NFDefine.proto:271-278)
    REQ_CREATE_TEAM = 1860
    ACK_CREATE_TEAM = 1861
    REQ_JOIN_TEAM = 1862
    ACK_JOIN_TEAM = 1863
    REQ_LEAVE_TEAM = 1864
    ACK_LEAVE_TEAM = 1865
    REQ_OPRMEMBER_TEAM = 1867
    ACK_OPRMEMBER_TEAM = 1868
    ACK_ONLINE_NOTIFY = 1290
    ACK_OFFLINE_NOTIFY = 1291

    # GM commands (NFDefine.proto:304-312); only the NORMAL entry point
    # is registered by the reference's NFCGmModule
    REQ_CMD_NORMAL = 10008
    # PVP matchmaking (NFDefine.proto:299-302)
    REQ_PVP_APPLY_MATCH = 10100
    ACK_PVP_APPLY_MATCH = 10101
    REQ_CREATE_PVP_ECTYPE = 10102
    ACK_CREATE_PVP_ECTYPE = 10103

    # SLG city building (NFDefine.proto:292-299 EGMI_REQ_BUY_FORM_SHOP..)
    REQ_BUY_FORM_SHOP = 20000
    ACK_BUY_FORM_SHOP = 20001
    REQ_MOVE_BUILD_OBJECT = 20002
    ACK_MOVE_BUILD_OBJECT = 20003
    REQ_UP_BUILD_LVL = 20101
    REQ_CREATE_ITEM = 20102
    REQ_BUILD_OPERATE = 20103


#: Frame-observatory sidecar opcodes: excluded from the flight-recorder
#: journal (net/roles/game.py ``_journal_tap``) so a journaled run
#: replays bit-identically whether tracing was on or off.
TRACE_MSG_IDS = frozenset({int(MsgID.FRAME_TRACE), int(MsgID.FRAME_TRACE_ACK)})

#: Reference cadence constants (NFINetClientModule.hpp:349,397)
KEEPALIVE_SECONDS = 10.0
RECONNECT_SECONDS = 10.0

#: Backoff ceiling for the reconnect RetryPolicy (net/retry.py);
#: RECONNECT_SECONDS stays the policy's *base* delay.
RECONNECT_CAP_SECONDS = 30.0

#: Heartbeat-lease thresholds (net/roles/master.py, world.py): an entry
#: not refreshed for SUSPECT ages is flagged, past DOWN it is treated as
#: dead (CRASH state, evicted from routed lists).  Tied to the 10 s
#: keepalive: 1.5 missed beats suspect, 3 missed beats down.
LEASE_SUSPECT_SECONDS = 1.5 * KEEPALIVE_SECONDS
LEASE_DOWN_SECONDS = 3.0 * KEEPALIVE_SECONDS
