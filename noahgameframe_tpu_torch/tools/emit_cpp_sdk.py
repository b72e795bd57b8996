"""C++ client-SDK emitter: wire messages + proto2 codec + framing.

The reference ships native client SDKs (NFClient/Unity3D C#, Cocos C++)
that speak the 6-byte-frame + protobuf MsgBase protocol.  Here the
client binding is GENERATED from the same declarative message set the
server speaks (net/wire.py + net/wire_families.py FIELDS tables), so
client and server can never drift: one header, zero dependencies, C++11.

Emitted surface per message:  a struct with typed fields + `has_<f>`
presence flags, `Encode(std::string&)` writing proto2 wire format in tag
order (matching protoc byte-for-byte, like the Python codec), and
`Decode(ptr, len)` tolerating unknown fields.  Plus frame helpers for
the u16 msg-id / u32 total-size big-endian header (`NFINet.h:63-68`).

tests/test_cpp_sdk.py compiles the emitted header with g++ and
round-trips real bytes against the Python codec.

A copy of ``noahgameframe_tpu/tools/emit_cpp_sdk.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package. The header's
``Regenerate with`` line keeps the reference module's name, so that both
packages emit the same bytes.
"""

from __future__ import annotations

import io
from typing import List

from ..net import wire, wire_families
from ..net.wire import Message

_SCALAR_CPP = {
    "int32": "int32_t",
    "int64": "int64_t",
    "uint64": "uint64_t",
    "bool": "bool",
    "enum": "int32_t",
    "float": "float",
    "double": "double",
    "bytes": "std::string",
    "string": "std::string",
}

_RUNTIME = r"""// GENERATED client SDK - do not edit by hand.
// Regenerate with: python -m noahgameframe_tpu.tools.emit_cpp_sdk > nfmsg.hpp
#pragma once
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace nfmsg {

// ----------------------------------------------------------- wire codec
inline void put_varint(std::string& out, uint64_t v) {
    while (v >= 0x80) { out.push_back(char((v & 0x7F) | 0x80)); v >>= 7; }
    out.push_back(char(v));
}
inline void put_tag(std::string& out, uint32_t tag, uint32_t wt) {
    put_varint(out, (uint64_t(tag) << 3) | wt);
}
inline void put_i64v(std::string& out, int64_t v) { put_varint(out, uint64_t(v)); }
inline void put_f32(std::string& out, float v) {
    char b[4]; std::memcpy(b, &v, 4); out.append(b, 4);
}
inline void put_f64(std::string& out, double v) {
    char b[8]; std::memcpy(b, &v, 8); out.append(b, 8);
}
inline void put_bytes(std::string& out, const std::string& v) {
    put_varint(out, v.size()); out.append(v);
}

struct Reader {
    const uint8_t* p; const uint8_t* end; bool ok = true;
    Reader(const void* d, size_t n)
        : p(static_cast<const uint8_t*>(d)), end(p + n) {}
    bool done() const { return p >= end; }
    uint64_t varint() {
        uint64_t v = 0; int shift = 0;
        while (p < end && shift <= 63) {
            uint8_t b = *p++;
            v |= uint64_t(b & 0x7F) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
        }
        ok = false; return 0;
    }
    float f32() {
        if (end - p < 4) { ok = false; return 0; }
        float v; std::memcpy(&v, p, 4); p += 4; return v;
    }
    double f64() {
        if (end - p < 8) { ok = false; return 0; }
        double v; std::memcpy(&v, p, 8); p += 8; return v;
    }
    std::string bytes() {
        uint64_t n = varint();
        if (!ok || uint64_t(end - p) < n) { ok = false; return {}; }
        std::string s(reinterpret_cast<const char*>(p), size_t(n)); p += n;
        return s;
    }
    void skip(uint32_t wt) {
        switch (wt) {
            case 0: varint(); break;
            case 1: p += 8; break;
            case 2: { uint64_t n = varint();
                      if (uint64_t(end - p) < n) ok = false; else p += n; break; }
            case 5: p += 4; break;
            default: ok = false;
        }
        if (p > end) ok = false;
    }
};

// ------------------------------------------------------ 6-byte framing
// u16 msg-id + u32 total-size, big-endian (total includes the header).
inline void frame(std::string& out, uint16_t msg_id, const std::string& body) {
    uint32_t total = uint32_t(body.size() + 6);
    out.push_back(char(msg_id >> 8)); out.push_back(char(msg_id & 0xFF));
    out.push_back(char(total >> 24)); out.push_back(char(total >> 16));
    out.push_back(char(total >> 8)); out.push_back(char(total));
    out.append(body);
}
// Max frame size mirrors the server codec (net/framing.py): a header
// announcing more is a protocol error, not a reason to buffer gigabytes.
const uint32_t kMaxFrameSize = 64u * 1024u * 1024u;

enum UnframeResult { UNFRAME_NEED_MORE = 0, UNFRAME_OK = 1, UNFRAME_ERROR = -1 };

inline UnframeResult unframe(const std::string& buf, size_t& off,
                             uint16_t& msg_id, std::string& body) {
    if (buf.size() - off < 6) return UNFRAME_NEED_MORE;
    const uint8_t* d = reinterpret_cast<const uint8_t*>(buf.data()) + off;
    msg_id = uint16_t(d[0]) << 8 | d[1];
    uint32_t total = uint32_t(d[2]) << 24 | uint32_t(d[3]) << 16 |
                     uint32_t(d[4]) << 8 | d[5];
    if (total < 6 || total > kMaxFrameSize) return UNFRAME_ERROR;
    if (buf.size() - off < total) return UNFRAME_NEED_MORE;
    body.assign(buf, off + 6, total - 6);
    off += total;
    return UNFRAME_OK;
}
"""


def _collect() -> List[type]:
    """All wire message classes, dependency-ordered (definition order —
    both modules define embedded messages before use)."""
    seen = {}
    for mod in (wire, wire_families):
        for c in vars(mod).values():
            if isinstance(c, type) and issubclass(c, Message) and c is not Message:
                seen.setdefault(c.__name__, c)
    return list(seen.values())


def _is_msg(t) -> bool:
    return isinstance(t, type) and issubclass(t, Message)


def _cpp_type(t) -> str:
    if _is_msg(t):
        return t.__name__
    return _SCALAR_CPP[t]


def _enc_scalar(field: str, t: str, out: io.StringIO, indent: str) -> None:
    w = out.write
    if t in ("int32", "int64", "uint64", "bool", "enum"):
        w(f"{indent}put_i64v(nf__out, int64_t({field}));\n")
    elif t == "float":
        w(f"{indent}put_f32(nf__out, {field});\n")
    elif t == "double":
        w(f"{indent}put_f64(nf__out, {field});\n")
    else:
        w(f"{indent}put_bytes(nf__out, {field});\n")


_WT = {"int32": 0, "int64": 0, "uint64": 0, "bool": 0, "enum": 0,
       "float": 5, "double": 1, "bytes": 2, "string": 2}

_DEC_SCALAR = {
    "int32": "int32_t(nf__r.varint())",
    "enum": "int32_t(nf__r.varint())",
    "int64": "int64_t(nf__r.varint())",
    "uint64": "nf__r.varint()",
    "bool": "(nf__r.varint() != 0)",
    "float": "nf__r.f32()",
    "double": "nf__r.f64()",
    "bytes": "nf__r.bytes()",
    "string": "nf__r.bytes()",
}


def emit_header() -> str:
    out = io.StringIO()
    w = out.write
    w(_RUNTIME)
    w("\n// ------------------------------------------------ messages\n")
    for cls in _collect():
        name = cls.__name__
        w(f"\nstruct {name} {{\n")
        for tag, fname, ftype, _ in cls.FIELDS:
            if isinstance(ftype, tuple):
                w(f"    std::vector<{_cpp_type(ftype[1])}> {fname};\n")
            else:
                w(f"    {_cpp_type(ftype)} {fname}{{}};\n")
                w(f"    bool has_{fname} = false;\n")
        # ---- encode
        w("    void Encode(std::string& nf__out) const {\n")
        for tag, fname, ftype, _ in cls.FIELDS:
            if isinstance(ftype, tuple):
                inner = ftype[1]
                w(f"        for (const auto& nf__it : {fname}) {{\n")
                if _is_msg(inner):
                    w(f"            put_tag(nf__out, {tag}, 2);\n")
                    w("            std::string nf__sub; nf__it.Encode(nf__sub);\n")
                    w("            put_bytes(nf__out, nf__sub);\n")
                else:
                    w(f"            put_tag(nf__out, {tag}, {_WT[inner]});\n")
                    _enc_scalar("nf__it", inner, out, "            ")
                w("        }\n")
            elif _is_msg(ftype):
                w(f"        if (has_{fname}) {{\n")
                w(f"            put_tag(nf__out, {tag}, 2);\n")
                w(f"            std::string nf__sub; {fname}.Encode(nf__sub);\n")
                w("            put_bytes(nf__out, nf__sub);\n")
                w("        }\n")
            else:
                w(f"        if (has_{fname}) {{\n")
                w(f"            put_tag(nf__out, {tag}, {_WT[ftype]});\n")
                _enc_scalar(fname, ftype, out, "            ")
                w("        }\n")
        w("    }\n")
        w("    std::string Encode() const {\n")
        w("        std::string nf__s; Encode(nf__s); return nf__s;\n    }\n")
        # ---- clear (Decode resets to defaults first, like protobuf Parse)
        w("    void Clear() {\n")
        for _tag, fname, ftype, _ in cls.FIELDS:
            if isinstance(ftype, tuple):
                w(f"        {fname}.clear();\n")
            else:
                w(f"        {fname} = {_cpp_type(ftype)}{{}};\n")
                w(f"        has_{fname} = false;\n")
        w("    }\n")
        # ---- decode
        w("    bool Decode(const void* nf__data, size_t nf__len) {\n")
        w("        Clear();\n")
        w("        Reader nf__r(nf__data, nf__len);\n")
        w("        while (!nf__r.done()) {\n")
        w("            uint64_t nf__key = nf__r.varint();\n")
        w("            if (!nf__r.ok) return false;\n")
        w("            switch (uint32_t(nf__key >> 3)) {\n")
        for tag, fname, ftype, _ in cls.FIELDS:
            rep = isinstance(ftype, tuple)
            inner = ftype[1] if rep else ftype
            expected_wt = 2 if _is_msg(inner) else _WT[inner]
            w(f"            case {tag}: {{\n")
            # a known tag with the wrong wire type is treated like an
            # unknown field (skip by actual type, stream stays aligned)
            w(f"                if (uint32_t(nf__key & 7) != {expected_wt}) {{\n")
            w("                    nf__r.skip(uint32_t(nf__key & 7));\n")
            w("                    if (!nf__r.ok) return false;\n")
            w("                    break;\n                }\n")
            if _is_msg(inner):
                w("                std::string nf__sub = nf__r.bytes();\n")
                w("                if (!nf__r.ok) return false;\n")
                if rep:
                    w(f"                {_cpp_type(inner)} nf__tmp{{}};\n")
                    w("                if (!nf__tmp.Decode(nf__sub.data(), nf__sub.size())) return false;\n")
                else:
                    w(f"                if (!{fname}.Decode(nf__sub.data(), nf__sub.size())) return false;\n")
            else:
                expr = _DEC_SCALAR[inner]
                if rep:
                    w(f"                {_cpp_type(inner)} nf__tmp = {expr};\n")
                else:
                    w(f"                {fname} = {expr};\n")
                w("                if (!nf__r.ok) return false;\n")
            if rep:
                w(f"                {fname}.push_back(nf__tmp);\n")
            else:
                w(f"                has_{fname} = true;\n")
            w("                break;\n            }\n")
        w("            default:\n")
        w("                nf__r.skip(uint32_t(nf__key & 7));\n")
        w("                if (!nf__r.ok) return false;\n")
        w("            }\n        }\n        return nf__r.ok;\n    }\n")
        w("};\n")
    w("\n}  // namespace nfmsg\n")
    return out.getvalue()


if __name__ == "__main__":
    print(emit_header())
