"""C# client-SDK emitter: wire messages + proto2 codec + framing.

The reference's Unity3D client is C# (NFClient/Unity3D) speaking the
6-byte-frame + protobuf MsgBase protocol via protoc-generated classes.
Here the C# binding is GENERATED from the same declarative message set
the server speaks (net/wire.py + net/wire_families.py FIELDS tables), so
client and server can never drift: one file, zero dependencies, C# 7 /
.NET Standard — drop `NFMsg.cs` into a Unity project next to the
generated `NFProtocolDefine.cs` name constants (tools/codegen.py).

Emitted surface per message: a class with typed fields + `Has<F>`
presence flags, `Encode()` writing proto2 wire format in tag order
(matching protoc byte-for-byte, like the Python and C++ codecs), and
`Decode(byte[], offset, length)` tolerating unknown fields and wrong
wire types (skip, stay aligned).  Plus frame helpers for the u16 msg-id
/ u32 total-size big-endian header (NFINet.h:63-68).

The emitter mirrors tools/emit_cpp_sdk.py structurally; the structural
test (tests/test_cs_sdk.py) cross-checks every message, field, tag and
wire type in the emitted text against the FIELDS tables (no C# compiler
ships in this image, so byte-level verification rides on the C++ twin,
which IS compiled and byte-verified against the Python codec).

A copy of ``noahgameframe_tpu/tools/emit_cs_sdk.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package. The file's
``Regenerate with`` line keeps the reference module's name, so that both
packages emit the same bytes (and the committed ``clients/unity/NFMsg.cs``).
"""

from __future__ import annotations

import io
from typing import List

from .emit_cpp_sdk import _WT, _collect, _is_msg

_SCALAR_CS = {
    "int32": "int",
    "int64": "long",
    "uint64": "ulong",
    "bool": "bool",
    "enum": "int",
    "float": "float",
    "double": "double",
    "bytes": "byte[]",
    "string": "byte[]",  # NF strings are raw bytes on the wire; callers
    # use Nf.Utf8()/Nf.Str() to convert
}

_DEFAULT_CS = {
    "int32": "0",
    "int64": "0",
    "uint64": "0",
    "bool": "false",
    "enum": "0",
    "float": "0f",
    "double": "0d",
    "bytes": "Nf.Empty",
    "string": "Nf.Empty",
}

_RUNTIME = r"""// GENERATED client SDK - do not edit by hand.
// Regenerate with: python -m noahgameframe_tpu.tools.emit_cs_sdk > NFMsg.cs
using System;
using System.Collections.Generic;
using System.IO;
using System.Text;

namespace NFMsg
{
    // ------------------------------------------------------- wire codec
    public static class Nf
    {
        public static readonly byte[] Empty = new byte[0];
        public static byte[] Utf8(string s) { return Encoding.UTF8.GetBytes(s); }
        public static string Str(byte[] b) { return Encoding.UTF8.GetString(b); }

        public static void PutVarint(MemoryStream o, ulong v)
        {
            while (v >= 0x80) { o.WriteByte((byte)((v & 0x7F) | 0x80)); v >>= 7; }
            o.WriteByte((byte)v);
        }
        public static void PutTag(MemoryStream o, uint tag, uint wt)
        {
            PutVarint(o, ((ulong)tag << 3) | wt);
        }
        public static void PutI64(MemoryStream o, long v) { PutVarint(o, (ulong)v); }
        public static void PutF32(MemoryStream o, float v)
        {
            var b = BitConverter.GetBytes(v);
            if (!BitConverter.IsLittleEndian) Array.Reverse(b);
            o.Write(b, 0, 4);
        }
        public static void PutF64(MemoryStream o, double v)
        {
            var b = BitConverter.GetBytes(v);
            if (!BitConverter.IsLittleEndian) Array.Reverse(b);
            o.Write(b, 0, 8);
        }
        public static void PutBytes(MemoryStream o, byte[] v)
        {
            PutVarint(o, (ulong)v.Length); o.Write(v, 0, v.Length);
        }

        // ---------------------------------------------------- 6-byte framing
        // u16 msg-id + u32 total-size, big-endian (total includes header).
        public const uint MaxFrameSize = 64u * 1024u * 1024u;

        public static byte[] Frame(ushort msgId, byte[] body)
        {
            uint total = (uint)(body.Length + 6);
            var f = new byte[total];
            f[0] = (byte)(msgId >> 8); f[1] = (byte)msgId;
            f[2] = (byte)(total >> 24); f[3] = (byte)(total >> 16);
            f[4] = (byte)(total >> 8); f[5] = (byte)total;
            Buffer.BlockCopy(body, 0, f, 6, body.Length);
            return f;
        }

        /// Returns 1 (frame ready: msgId/body set, off advanced),
        /// 0 (need more data), -1 (protocol error).
        public static int Unframe(byte[] buf, int len, ref int off,
                                  out ushort msgId, out byte[] body)
        {
            msgId = 0; body = Empty;
            if (len - off < 6) return 0;
            msgId = (ushort)((buf[off] << 8) | buf[off + 1]);
            uint total = ((uint)buf[off + 2] << 24) | ((uint)buf[off + 3] << 16)
                       | ((uint)buf[off + 4] << 8) | buf[off + 5];
            if (total < 6 || total > MaxFrameSize) return -1;
            if (len - off < total) return 0;
            body = new byte[total - 6];
            Buffer.BlockCopy(buf, off + 6, body, 0, (int)(total - 6));
            off += (int)total;
            return 1;
        }
    }

    public class NfReader
    {
        public byte[] D; public int P; public int End; public bool Ok = true;
        public NfReader(byte[] d, int off, int len) { D = d; P = off; End = off + len; }
        public bool Done() { return P >= End; }
        public ulong Varint()
        {
            ulong v = 0; int shift = 0;
            while (P < End && shift <= 63)
            {
                byte b = D[P++];
                v |= (ulong)(b & 0x7F) << shift;
                if ((b & 0x80) == 0) return v;
                shift += 7;
            }
            Ok = false; return 0;
        }
        public float F32()
        {
            if (End - P < 4) { Ok = false; return 0; }
            var b = new byte[4]; Buffer.BlockCopy(D, P, b, 0, 4); P += 4;
            if (!BitConverter.IsLittleEndian) Array.Reverse(b);
            return BitConverter.ToSingle(b, 0);
        }
        public double F64()
        {
            if (End - P < 8) { Ok = false; return 0; }
            var b = new byte[8]; Buffer.BlockCopy(D, P, b, 0, 8); P += 8;
            if (!BitConverter.IsLittleEndian) Array.Reverse(b);
            return BitConverter.ToDouble(b, 0);
        }
        public byte[] Bytes()
        {
            ulong n = Varint();
            if (!Ok || (ulong)(End - P) < n) { Ok = false; return Nf.Empty; }
            var s = new byte[n]; Buffer.BlockCopy(D, P, s, 0, (int)n); P += (int)n;
            return s;
        }
        public void Skip(uint wt)
        {
            switch (wt)
            {
                case 0: Varint(); break;
                case 1: P += 8; break;
                case 2: { ulong n = Varint();
                          if ((ulong)(End - P) < n) Ok = false; else P += (int)n; break; }
                case 5: P += 4; break;
                default: Ok = false; break;
            }
            if (P > End) Ok = false;
        }
    }
"""


def _cs_type(t) -> str:
    if _is_msg(t):
        return t.__name__
    return _SCALAR_CS[t]


def _cs_default(t) -> str:
    if _is_msg(t):
        return f"new {t.__name__}()"
    return _DEFAULT_CS[t]


def _enc_scalar(expr: str, t: str, w, indent: str) -> None:
    if t in ("int32", "int64", "enum"):
        w(f"{indent}Nf.PutI64(nf__o, (long){expr});\n")
    elif t == "uint64":
        w(f"{indent}Nf.PutVarint(nf__o, {expr});\n")
    elif t == "bool":
        w(f"{indent}Nf.PutVarint(nf__o, {expr} ? 1ul : 0ul);\n")
    elif t == "float":
        w(f"{indent}Nf.PutF32(nf__o, {expr});\n")
    elif t == "double":
        w(f"{indent}Nf.PutF64(nf__o, {expr});\n")
    else:
        w(f"{indent}Nf.PutBytes(nf__o, {expr});\n")


_DEC_SCALAR = {
    "int32": "(int)nf__r.Varint()",
    "enum": "(int)nf__r.Varint()",
    "int64": "(long)nf__r.Varint()",
    "uint64": "nf__r.Varint()",
    "bool": "nf__r.Varint() != 0",
    "float": "nf__r.F32()",
    "double": "nf__r.F64()",
    "bytes": "nf__r.Bytes()",
    "string": "nf__r.Bytes()",
}


def _pascal(name: str) -> str:
    return "".join(p[:1].upper() + p[1:] for p in name.split("_"))


def emit_cs() -> str:
    out = io.StringIO()
    w = out.write
    w(_RUNTIME)
    for cls in _collect():
        name = cls.__name__
        w(f"\n    public class {name}\n    {{\n")
        for tag, fname, ftype, _ in cls.FIELDS:
            if isinstance(ftype, tuple):
                w(f"        public List<{_cs_type(ftype[1])}> {fname} = "
                  f"new List<{_cs_type(ftype[1])}>();\n")
            else:
                w(f"        public {_cs_type(ftype)} {fname} = {_cs_default(ftype)};\n")
                w(f"        public bool Has{_pascal(fname)} = false;\n")
        # ---- encode
        w("        public void Encode(MemoryStream nf__o)\n        {\n")
        for tag, fname, ftype, _ in cls.FIELDS:
            if isinstance(ftype, tuple):
                inner = ftype[1]
                w(f"            foreach (var nf__it in {fname})\n            {{\n")
                if _is_msg(inner):
                    w(f"                Nf.PutTag(nf__o, {tag}, 2);\n")
                    w("                var nf__sub = new MemoryStream(); nf__it.Encode(nf__sub);\n")
                    w("                Nf.PutBytes(nf__o, nf__sub.ToArray());\n")
                else:
                    w(f"                Nf.PutTag(nf__o, {tag}, {_WT[inner]});\n")
                    _enc_scalar("nf__it", inner, w, "                ")
                w("            }\n")
            elif _is_msg(ftype):
                w(f"            if (Has{_pascal(fname)})\n            {{\n")
                w(f"                Nf.PutTag(nf__o, {tag}, 2);\n")
                w(f"                var nf__sub = new MemoryStream(); {fname}.Encode(nf__sub);\n")
                w("                Nf.PutBytes(nf__o, nf__sub.ToArray());\n")
                w("            }\n")
            else:
                w(f"            if (Has{_pascal(fname)})\n            {{\n")
                w(f"                Nf.PutTag(nf__o, {tag}, {_WT[ftype]});\n")
                _enc_scalar(fname, ftype, w, "                ")
                w("            }\n")
        w("        }\n")
        w("        public byte[] Encode()\n        {\n")
        w("            var nf__o = new MemoryStream(); Encode(nf__o); return nf__o.ToArray();\n")
        w("        }\n")
        # ---- clear
        w("        public void Clear()\n        {\n")
        for _tag, fname, ftype, _ in cls.FIELDS:
            if isinstance(ftype, tuple):
                w(f"            {fname}.Clear();\n")
            else:
                w(f"            {fname} = {_cs_default(ftype)};\n")
                w(f"            Has{_pascal(fname)} = false;\n")
        w("        }\n")
        # ---- decode
        w("        public bool Decode(byte[] nf__data, int nf__off, int nf__len)\n        {\n")
        w("            Clear();\n")
        w("            var nf__r = new NfReader(nf__data, nf__off, nf__len);\n")
        w("            while (!nf__r.Done())\n            {\n")
        w("                ulong nf__key = nf__r.Varint();\n")
        w("                if (!nf__r.Ok) return false;\n")
        w("                switch ((uint)(nf__key >> 3))\n                {\n")
        for tag, fname, ftype, _ in cls.FIELDS:
            rep = isinstance(ftype, tuple)
            inner = ftype[1] if rep else ftype
            expected_wt = 2 if _is_msg(inner) else _WT[inner]
            w(f"                    case {tag}:\n")
            w("                    {\n")
            # wrong wire type for a known tag: skip like an unknown field
            w(f"                        if ((uint)(nf__key & 7) != {expected_wt})\n")
            w("                        {\n")
            w("                            nf__r.Skip((uint)(nf__key & 7));\n")
            w("                            if (!nf__r.Ok) return false;\n")
            w("                            break;\n")
            w("                        }\n")
            if _is_msg(inner):
                w("                        var nf__sub = nf__r.Bytes();\n")
                w("                        if (!nf__r.Ok) return false;\n")
                w(f"                        var nf__m = new {inner.__name__}();\n")
                w("                        if (!nf__m.Decode(nf__sub, 0, nf__sub.Length)) return false;\n")
                if rep:
                    w(f"                        {fname}.Add(nf__m);\n")
                else:
                    w(f"                        {fname} = nf__m; Has{_pascal(fname)} = true;\n")
            else:
                if rep:
                    w(f"                        {fname}.Add({_DEC_SCALAR[inner]});\n")
                    w("                        if (!nf__r.Ok) return false;\n")
                else:
                    w(f"                        {fname} = {_DEC_SCALAR[inner]};\n")
                    w("                        if (!nf__r.Ok) return false;\n")
                    w(f"                        Has{_pascal(fname)} = true;\n")
            w("                        break;\n")
            w("                    }\n")
        w("                    default:\n")
        w("                        nf__r.Skip((uint)(nf__key & 7));\n")
        w("                        if (!nf__r.Ok) return false;\n")
        w("                        break;\n")
        w("                }\n")
        w("            }\n")
        w("            return nf__r.Ok;\n")
        w("        }\n")
        w("    }\n")
    w("}\n")
    return out.getvalue()


def emit_messages() -> List[str]:
    """Names of every emitted message class (for tests/tools)."""
    return [c.__name__ for c in _collect()]


if __name__ == "__main__":
    print(emit_cs())
