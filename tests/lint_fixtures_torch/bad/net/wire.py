"""struct-codec violations: every consistency check trips once."""
import struct

_HEAD = struct.Struct(">HI")
HEAD_LENGTH = 7  # real size is 6

_REC = struct.Struct(">HII")
REC_SIZE = _REC.size  # 8 bytes

BROKEN = struct.Struct(">Qz")  # 'z' is not a format char


def encode(a, b):
    return struct.pack(">HH", a, b, 99)  # 2-field format, 3 values


def decode(buf):
    kind, size, extra = struct.unpack(">HH", buf)  # 2 values, 3 targets
    return kind, size, extra
