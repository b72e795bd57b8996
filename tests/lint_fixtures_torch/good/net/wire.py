"""Clean wire codec: sizes, comments and arities all agree."""
import struct

_HEAD = struct.Struct(">HI")
HEAD_LENGTH = 6

_REC = struct.Struct(">HII")
REC_SIZE = _REC.size  # 10 bytes


def encode(a, b):
    return struct.pack(">HH", a, b)


def decode(buf):
    kind, size = struct.unpack(">HH", buf)
    return kind, size


def head(buf):
    msg_id, length = _HEAD.unpack(buf[:HEAD_LENGTH])
    return msg_id, length
