"""Golden byte vectors for client-SDK validation without a compiler.

No C# toolchain ships in this image, so the generated Unity binding
(`NFMsg.cs`, tools/emit_cs_sdk.py) can't be compile-tested the way the
C++ SDK is (tests/test_cpp_sdk.py).  Instead this module freezes the
wire contract as data: one deterministic instance of EVERY declared
message, encoded by the Python codec (itself protoc-byte-verified,
tests/test_wire_protoc.py), written as `name \\t hex` lines — plus a
generated C# harness that replays the file against NFMsg.cs
(decode -> re-encode -> byte-compare) the moment a Unity project or
dotnet SDK is available.

Reference analog: the Unity3D client's protobuf-net bindings are only
validated by running the game (NFClient/Unity3D); here the contract is
checkable offline on both sides.

A copy of ``noahgameframe_tpu/tools/golden_vectors.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import io
from typing import List, Tuple

from ..net.wire import Message
from .emit_cpp_sdk import _collect


class _Gen:
    """Deterministic field filler (same spirit as tests/test_cpp_sdk.py):
    every scalar family exercised, negatives included (they encode as
    10-byte varints — the classic cross-language divergence point)."""

    def __init__(self) -> None:
        self.n = 0

    def value(self, ftype):
        self.n += 1
        i = self.n
        if isinstance(ftype, tuple):  # repeated
            return [self.value(ftype[1]) for _ in range(2)]
        if isinstance(ftype, type) and issubclass(ftype, Message):
            return self.message(ftype)
        return {
            "int32": [5, -3, 0, 1 << 28][i % 4],
            "int64": [9, -1, 1 << 40][i % 3],
            "uint64": [0, 7, (1 << 62) + 3][i % 3],
            "bool": bool(i % 2),
            "enum": [0, 2, -1][i % 3],
            "float": [0.5, -2.25, 100.125][i % 3],
            "double": [1.5, -3.25e10][i % 2],
            "bytes": b"b%d" % i,
            "string": "s%d" % i,
        }[ftype]

    def message(self, cls):
        return cls(**{f[1]: self.value(f[2]) for f in cls.FIELDS})


def golden_cases() -> List[Tuple[str, bytes]]:
    """(message name, encoded bytes) for every declared wire message,
    deterministic across runs (one shared counter, definition order)."""
    gen = _Gen()
    return [(cls.__name__, gen.message(cls).encode()) for cls in _collect()]


def emit_vectors() -> str:
    """The `NFMsgGolden.tsv` text: `name<TAB>hex` per message."""
    out = io.StringIO()
    out.write("# GENERATED golden wire vectors - do not edit by hand.\n")
    out.write("# Regenerate with scripts/emit_client_vectors.py.\n")
    for name, raw in golden_cases():
        out.write(f"{name}\t{raw.hex()}\n")
    return out.getvalue()


def emit_cs_harness() -> str:
    """`NFMsgGoldenTest.cs`: standalone console program (C# 7, no deps
    beyond the generated NFMsg.cs) that replays the vector file.

    For each line it decodes the golden bytes into the named message,
    re-encodes, and byte-compares — any field-order, tag, wire-type or
    varint divergence in the C# binding fails loudly.  Exit 0 = all pass.
    """
    names = [name for name, _ in golden_cases()]
    out = io.StringIO()
    out.write("// GENERATED golden-vector replay harness - do not edit.\n")
    out.write("// Usage: NFMsgGoldenTest <path-to-NFMsgGolden.tsv>\n")
    out.write("// Compile next to the generated NFMsg.cs.\n\n")
    out.write("using System;\nusing System.IO;\n\n")
    out.write("public static class NFMsgGoldenTest\n{\n")
    out.write(
        "    static byte[] Roundtrip(string name, byte[] raw)\n    {\n"
        "        switch (name)\n        {\n"
    )
    for name in names:
        out.write(
            f'            case "{name}": {{ var m = new NFMsg.{name}(); '
            "if (!m.Decode(raw, 0, raw.Length)) return null; "
            "return m.Encode(); }\n"
        )
    out.write(
        "            default: return null;\n"
        "        }\n    }\n\n"
    )
    out.write(
        "    public static int Main(string[] args)\n    {\n"
        "        int bad = 0, n = 0;\n"
        "        foreach (var line in File.ReadAllLines(args[0]))\n"
        "        {\n"
        "            if (line.Length == 0 || line[0] == '#') continue;\n"
        "            var parts = line.Split('\\t');\n"
        "            var raw = new byte[parts[1].Length / 2];\n"
        "            for (int i = 0; i < raw.Length; i++)\n"
        "                raw[i] = Convert.ToByte(parts[1].Substring(2 * i, 2), 16);\n"
        "            var back = Roundtrip(parts[0], raw);\n"
        "            n++;\n"
        "            bool ok = back != null && back.Length == raw.Length;\n"
        "            if (ok) for (int i = 0; i < raw.Length; i++)\n"
        "                if (back[i] != raw[i]) { ok = false; break; }\n"
        "            if (!ok) { bad++; Console.WriteLine(\"FAIL \" + parts[0]); }\n"
        "        }\n"
        "        Console.WriteLine(n + \" vectors, \" + bad + \" failures\");\n"
        "        return bad == 0 && n > 0 ? 0 : 1;\n"
        "    }\n}\n"
    )
    return out.getvalue()
