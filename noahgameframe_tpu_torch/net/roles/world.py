"""The world role's constants that the game role uses.

``CROSS_SYNC_MSGS`` is the game-to-world sync traffic the world relays to
every other game server, so players on different game servers converge on
each other's public state (reference NFCWorldNet_ServerModule.cpp:600-830
rebuilds and re-sends property and record packs world-side; here the
already-encoded game message is relayed verbatim).  The game role
subscribes its world link to these ids.

Counterpart of the constant in ``noahgameframe_tpu/net/roles/world.py``;
the ``WorldRole`` itself comes with the cluster roles.
"""

from __future__ import annotations

from ..defines import MsgID

CROSS_SYNC_MSGS = (
    MsgID.ACK_ONLINE_NOTIFY,
    MsgID.ACK_OFFLINE_NOTIFY,
    MsgID.ACK_PROPERTY_INT,
    MsgID.ACK_PROPERTY_FLOAT,
    MsgID.ACK_PROPERTY_STRING,
    MsgID.ACK_PROPERTY_OBJECT,
    MsgID.ACK_PROPERTY_VECTOR2,
    MsgID.ACK_PROPERTY_VECTOR3,
    MsgID.ACK_ADD_ROW,
    MsgID.ACK_REMOVE_ROW,
    MsgID.ACK_SWAP_ROW,
    MsgID.ACK_RECORD_INT,
    MsgID.ACK_RECORD_FLOAT,
    MsgID.ACK_RECORD_STRING,
    MsgID.ACK_RECORD_OBJECT,
    MsgID.ACK_RECORD_VECTOR3,
)
