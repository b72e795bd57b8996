"""The port's tools (noahgameframe_tpu_torch/tools/) against the JAX package's.

- tests/test_codegen.py's cases on the port's pipeline, and both packages'
  pipelines over the same CSV and XLSX sheets: byte-equal Struct/Ini XML,
  name constants (Python, C#, Java) and DDL, with the port's XML read by
  both packages' loaders into equal class specs;
- tests/test_cs_sdk.py, test_golden_vectors.py and test_wire_fuzz.py on
  the port's wire classes and emitters, whose C++ header, C# binding,
  golden vectors and C# harness are byte-equal to the JAX package's and
  to the committed clients/unity/ files;
- tests/test_cpp_sdk.py's round-trips through one binary compiled (with
  ``-Wall -Werror``) from the port's header and ``chip_smoke.cpp_driver``
  (msg id = index in ``ALL``), fed every golden vector of the port's codec
  as well as the representative cases.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import re
import shutil
import sqlite3
import subprocess
import zlib
from pathlib import Path

import pytest

import noahgameframe_tpu.tools as jax_tools
import noahgameframe_tpu_torch.net.wire as wire
import noahgameframe_tpu_torch.net.wire_families as families
import noahgameframe_tpu_torch.tools as port_tools
from noahgameframe_tpu.core.schema import load_logic_class_xml as jax_load_logic_class_xml
from noahgameframe_tpu.tools import emit_cpp_sdk as jax_cpp
from noahgameframe_tpu.tools import emit_cs_sdk as jax_cs
from noahgameframe_tpu.tools import golden_vectors as jax_golden
from noahgameframe_tpu_torch.core.element import ElementStore
from noahgameframe_tpu_torch.core.schema import load_logic_class_xml
from noahgameframe_tpu_torch.net.framing import HEAD_LENGTH, FrameDecoder, ProtocolError, pack_frame
from noahgameframe_tpu_torch.net.wire import Message
from noahgameframe_tpu_torch.tools import (
    CodegenPipeline,
    load_class_csv,
    load_class_xlsx,
)
from noahgameframe_tpu_torch.tools.emit_cpp_sdk import _WT, _collect, _is_msg, emit_header
from noahgameframe_tpu_torch.tools.emit_cs_sdk import emit_cs, emit_messages
from noahgameframe_tpu_torch.tools.golden_vectors import emit_cs_harness, emit_vectors, golden_cases
from noahgameframe_tpu_torch.tools.xlsx import read_xlsx_sheets, write_xlsx
from chip_smoke import cpp_driver
from test_codegen import HERO_CSV, HERO_INI_CSV, IOBJECT_CSV, write_inputs
from test_cpp_sdk import frame
from test_wire_fuzz import _frames
from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
UNITY = REPO / "clients" / "unity"

# -- codegen: tests/test_codegen.py on the port -------------------------------------

BAG_CSV = ("[class],name=Hero\n[property]\nName,Type,Public\nHP,int,1\n"
           "class,string,1\n"
           "[record:Bag],rows=4,public=1\nTag,Type\nItem,string\nCount,int\n")


def test_load_class_csv(tmp_path):
    write_inputs(tmp_path)
    cdef = load_class_csv(tmp_path / "Hero.csv")
    assert cdef.name == "Hero" and cdef.parent == "IObject"
    by_name = {p.name: p for p in cdef.properties}
    assert by_name["HP"].save and by_name["HP"].public
    assert by_name["Speed"].type.name == "FLOAT" and not by_name["Speed"].save
    rec = cdef.records[0]
    assert rec.name == "Inventory" and rec.max_rows == 8
    assert [c.tag for c in rec.cols] == ["ItemID", "Count"]
    assert rec.public and rec.save and not rec.private
    assert cdef.components[0].name == "HeroAI"


def test_pipeline_roundtrips_through_the_ports_loaders(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    write_inputs(src)
    report = CodegenPipeline(src, out).run()
    assert sorted(report["classes"]) == ["Hero", "IObject"]

    reg = load_logic_class_xml(out / "Struct" / "LogicClass.xml", data_root=out)
    assert "Hero" in reg
    names = [p.name for p in reg._flatten("Hero").properties]
    assert names[:4] == ["ID", "ClassName", "SceneID", "GroupID"]  # inherited
    assert "HP" in names and "Home" in names
    assert reg.spec("Hero").records["Inventory"].max_rows == 8

    es = ElementStore(reg)
    assert es.load_all(out) == 2
    assert es.element("hero_alpha").values["HP"] == 120
    assert abs(es.element("hero_beta").values["Speed"] - 2.25) < 1e-6

    ns: dict = {}
    exec((out / "proto_define.py").read_text(), ns)
    assert ns["Hero"].HP == "HP"
    assert ns["Hero"].ThisName == "Hero"
    assert ns["Hero"].R_Inventory.Col_Count == 1
    assert ns["IObject"].SceneID == "SceneID"

    ddl = (out / "NFrame.sql").read_text()
    assert '"HP" BIGINT' in ddl and '"Title" TEXT' in ddl
    assert '"Speed"' not in ddl  # not save-flagged
    sqlite3.connect(":memory:").executescript(ddl)


def test_xlsx_roundtrip(tmp_path):
    rows = [
        ["[class]", "name=Mini", "parent="],
        ["[property]"],
        ["Name", "Type", "Public", "Private", "Save"],
        ["Level", "int", 1, 1, 1],
        ["Nick", "string", 1, 0, 0],
    ]
    wb = tmp_path / "classes.xlsx"
    write_xlsx(wb, {"Mini": rows})
    assert read_xlsx_sheets(wb)["Mini"][3][0] == "Level"
    (cdef,) = load_class_xlsx(wb)
    assert cdef.name == "Mini"
    assert cdef.properties[0].name == "Level" and cdef.properties[0].save
    assert cdef.properties[1].type.name == "STRING"


def test_generated_world_actually_runs(tmp_path):
    """Sheets -> XML -> registry -> a world ticking on the CPU."""
    from noahgameframe_tpu_torch.core.store import StoreConfig
    from noahgameframe_tpu_torch.kernel import Kernel, Plugin, PluginManager

    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    write_inputs(src)
    CodegenPipeline(src, out).run()
    reg = load_logic_class_xml(out / "Struct" / "LogicClass.xml", data_root=out)
    k = Kernel(reg, StoreConfig(default_capacity=16), device="cpu")
    pm = PluginManager()
    pm.register_plugin(Plugin("KernelPlugin", [k]))
    k.elements.load_all(out)
    pm.start()
    g = k.create_from_element("Hero", "hero_alpha")
    assert int(k.get_property(g, "HP")) == 120
    pm.run(2)
    assert k.tick_count == 2


def test_orphan_class_fails_loudly(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    (src / "Orphan.csv").write_text(
        "[class],name=Orphan,parent=Nowhere\n[property]\nName,Type\nHP,int\n")
    with pytest.raises(ValueError, match="Orphan"):
        CodegenPipeline(src, out).run()


def test_blank_type_cell_defaults_to_int(tmp_path):
    (tmp_path / "C.csv").write_text("[class],name=C\n[property]\nName,Type,Public\nFoo,,1\n")
    assert load_class_csv(tmp_path / "C.csv").properties[0].type.name == "INT"


def test_cs_constants_emitter(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    (src / "Hero.csv").write_text(BAG_CSV)
    report = CodegenPipeline(src, out).run()
    assert [p for p in report["constants"] if p.endswith(".cs")]
    text = (out / "NFProtocolDefine.cs").read_text()
    assert "namespace NFrame" in text
    assert 'public const string HP = "HP";' in text
    assert 'public const string _class = "class";' in text
    assert "public static class R_Bag" in text
    assert "public const int Col_Count = 1" in text
    assert "public const int MaxRows = 4" in text


def test_java_constants_emitter(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    (src / "Hero.csv").write_text(BAG_CSV)
    report = CodegenPipeline(src, out).run()
    assert [p for p in report["constants"] if p.endswith(".java")]
    text = (out / "NFProtocolDefine.java").read_text()
    assert text.count("public final class NFProtocolDefine") == 1
    assert "package nframe;" in text
    assert 'public static final String HP = "HP";' in text
    assert 'public static final String _class = "class";' in text
    assert "public static final class R_Bag" in text
    assert "public static final int Col_Count = 1;" in text
    assert "public static final int MaxRows = 4;" in text
    assert text.count("{") == text.count("}")


# -- codegen: both packages over the same sheets ------------------------------------


def _sheet_rows(text: str) -> list:
    import csv
    import io

    return list(csv.reader(io.StringIO(text)))


def _write_sources(src: Path, fmt: str) -> None:
    src.mkdir()
    if fmt == "csv":
        write_inputs(src)
        (src / "Bag.csv").write_text(BAG_CSV.replace("name=Hero", "name=Bag"))
    else:
        write_xlsx(src / "classes.xlsx", {"IObject": _sheet_rows(IOBJECT_CSV),
                                          "Hero": _sheet_rows(HERO_CSV),
                                          "Bag": _sheet_rows(BAG_CSV.replace("name=Hero",
                                                                             "name=Bag"))})
        (src / "Hero.ini.csv").write_text(HERO_INI_CSV)


def _emitted(out: Path) -> dict:
    return {p.relative_to(out).as_posix(): p.read_bytes()
            for p in sorted(out.rglob("*")) if p.is_file()}


def _plain(x):
    """Either package's schema objects as plain data (enums by name)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _spec_view(reg, cname: str) -> dict:
    spec = reg.spec(cname)
    return _plain({"prop_order": spec.prop_order, "slots": spec.slots,
                   "records": spec.records, "record_order": spec.record_order,
                   "banks": (spec.n_i32, spec.n_f32, spec.n_vec)})


@pytest.mark.parametrize("fmt", ["csv", "xlsx"])
def test_both_pipelines_emit_byte_equal_files(tmp_path, fmt):
    src = tmp_path / "src"
    _write_sources(src, fmt)
    outs = {}
    for name, tools in (("jax", jax_tools), ("port", port_tools)):
        report = tools.CodegenPipeline(src, tmp_path / name).run()
        assert sorted(report["classes"]) == ["Bag", "Hero", "IObject"]
        outs[name] = _emitted(tmp_path / name)
    assert set(outs["port"]) >= {"Struct/LogicClass.xml", "Ini/Hero.xml", "proto_define.py",
                                 "NFProtocolDefine.cs", "NFProtocolDefine.java", "NFrame.sql"}
    assert outs["port"] == outs["jax"]
    # the port's XML reads into equal specs through both packages' loaders
    out = tmp_path / "port"
    xml = out / "Struct" / "LogicClass.xml"
    jreg = jax_load_logic_class_xml(xml, data_root=out)
    preg = load_logic_class_xml(xml, data_root=out)
    for cname in ("IObject", "Hero", "Bag"):
        assert _spec_view(preg, cname) == _spec_view(jreg, cname), cname


# -- the client SDK emitters -----------------------------------------------------


@pytest.mark.parametrize("emit, jax_emit, committed", [
    (emit_header, jax_cpp.emit_header, None),
    (emit_cs, jax_cs.emit_cs, "NFMsg.cs"),
    (emit_vectors, jax_golden.emit_vectors, "NFMsgGolden.tsv"),
    (emit_cs_harness, jax_golden.emit_cs_harness, "NFMsgGoldenTest.cs"),
], ids=["cpp_header", "cs_binding", "golden_vectors", "cs_harness"])
def test_emitters_are_byte_equal_to_jax_and_committed(emit, jax_emit, committed):
    text = emit()
    assert text == jax_emit()
    if committed is not None:
        assert (UNITY / committed).read_text() == text


def test_every_message_and_field_emitted():
    src = emit_cs()
    assert len(emit_messages()) > 40
    for cls in _collect():
        assert f"public class {cls.__name__}" in src, cls.__name__
        body = src.split(f"public class {cls.__name__}\n")[1]
        nxt = body.find("\n    public class ")
        body = body[:nxt] if nxt > 0 else body
        for tag, fname, ftype, _ in cls.FIELDS:
            inner = ftype[1] if isinstance(ftype, tuple) else ftype
            wt = 2 if _is_msg(inner) else _WT[inner]
            assert re.search(rf"\b{fname}\b", body), (cls.__name__, fname)
            assert f"Nf.PutTag(nf__o, {tag}, {wt});" in body, (cls.__name__, fname, tag, wt)
            assert f"case {tag}:" in body, (cls.__name__, fname, tag)


def test_no_generated_identifier_can_shadow_a_field():
    src = emit_cs()
    for cls in _collect():
        for _tag, fname, _ftype, _ in cls.FIELDS:
            assert not fname.startswith("nf__"), (cls.__name__, fname)
    assert "public bool Decode(byte[] nf__data, int nf__off, int nf__len)" in src
    assert "ulong nf__key" in src and "var nf__r" in src


def test_emitted_source_is_brace_balanced_and_framed():
    src = emit_cs()
    assert src.count("{") == src.count("}")
    assert "64u * 1024u * 1024u" in src
    assert "msgId >> 8" in src
    assert "total >> 24" in src


def test_tag_wire_types_match_the_ports_codec():
    raw = wire.MsgBase(player_id=wire.Ident(svrid=3, index=9), msg_data=b"xy").encode()
    assert raw[0] >> 3 == 1 and raw[0] & 7 == 2
    body = emit_cs().split("public class MsgBase\n")[1]
    assert "Nf.PutTag(nf__o, 1, 2);" in body


def _parse_vectors(text: str):
    return [(name, bytes.fromhex(hexs)) for name, hexs in
            (line.split("\t") for line in text.splitlines()
             if line and not line.startswith("#"))]


def test_vectors_cover_every_message_and_roundtrip():
    by_name = {c.__name__: c for c in _collect()}
    rows = _parse_vectors(emit_vectors())
    assert {n for n, _ in rows} == set(by_name)
    for name, raw in rows:
        assert raw, f"{name} vector is empty"
        assert by_name[name].decode(raw).encode() == raw, name


def test_vectors_are_deterministic():
    assert emit_vectors() == emit_vectors()
    assert [r for _, r in golden_cases()] == [r for _, r in golden_cases()]


def test_harness_replays_every_message():
    harness = emit_cs_harness()
    for cls in _collect():
        assert f'case "{cls.__name__}":' in harness
        assert f"new NFMsg.{cls.__name__}()" in harness
    assert harness.count("{") == harness.count("}")


# -- tests/test_wire_fuzz.py on the port's codec ---------------------------------------

BOUNDARY_INTS = [0, 1, -1, 127, 128, 2**31 - 1, -(2**31), 2**53, 5]


def _rand_scalar(t: str, rng: random.Random):
    if t in ("int32", "enum"):
        return int(rng.choice([0, 1, -1, 127, 2**31 - 1, -(2**31), rng.randint(-9999, 9999)]))
    if t == "int64":
        return rng.choice(BOUNDARY_INTS + [rng.randint(-(2**53), 2**53)])
    if t == "uint64":
        return rng.choice([0, 1, 2**63, 2**64 - 1, rng.randint(0, 2**53)])
    if t == "bool":
        return rng.random() < 0.5
    if t == "float":
        import struct

        return struct.unpack("<f", struct.pack("<f", rng.uniform(-1e6, 1e6)))[0]
    if t == "double":
        return rng.uniform(-1e12, 1e12)
    return bytes(rng.randrange(256) for _ in range(rng.randrange(0, 12)))


def _fill(cls, rng: random.Random, depth: int = 0):
    msg = cls()
    for _tag, fname, ftype, _default in cls.FIELDS:
        if isinstance(ftype, tuple):
            inner = ftype[1]
            n = rng.randrange(0, 3 if depth < 2 else 1)
            setattr(msg, fname, [_fill(inner, rng, depth + 1) if _is_msg(inner)
                                 else _rand_scalar(inner, rng) for _ in range(n)])
        elif _is_msg(ftype):
            if rng.random() < 0.8 and depth < 3:
                setattr(msg, fname, _fill(ftype, rng, depth + 1))
        elif rng.random() < 0.85:
            setattr(msg, fname, _rand_scalar(ftype, rng))
    return msg


@pytest.mark.parametrize("cls", _collect(), ids=lambda c: c.__name__)
def test_roundtrip_fuzz(cls):
    rng = random.Random(zlib.crc32(cls.__name__.encode()))
    for _ in range(8):
        m = _fill(cls, rng)
        raw = m.encode()
        assert m == cls.decode(raw), (cls.__name__, raw.hex())


def test_frame_duplicates_decode_twice():
    frames = _frames(random.Random(1))
    stream = b"".join(pack_frame(m, b) + pack_frame(m, b) for m, b in frames)
    assert FrameDecoder().feed(stream) == [f for pair in zip(frames, frames) for f in pair]


def test_frame_random_chunking_identical():
    frames = _frames(random.Random(2))
    stream = b"".join(pack_frame(m, b) for m, b in frames)
    for trial in range(5):
        r = random.Random(100 + trial)
        dec, got, i = FrameDecoder(), [], 0
        while i < len(stream):
            j = min(len(stream), i + r.randrange(1, 17))
            got.extend(dec.feed(stream[i:j]))
            i = j
        assert got == frames, f"chunking trial {trial}"


def test_frame_truncated_tail_pends_without_crash():
    frames = _frames(random.Random(3), n=5)
    stream = b"".join(pack_frame(m, b) for m, b in frames)
    cut = len(stream) - len(frames[-1][1]) // 2 - 1
    dec = FrameDecoder()
    assert dec.feed(stream[:cut]) == frames[:-1]
    assert dec.feed(stream[cut:]) == frames[-1:]


def test_frame_corrupt_headers_raise_protocol_error_only():
    rng = random.Random(4)
    for _ in range(200):
        garbage = bytes(rng.randrange(256) for _ in range(rng.randrange(HEAD_LENGTH, 64)))
        try:
            FrameDecoder().feed(garbage)
        except ProtocolError:
            pass


# -- tests/test_cpp_sdk.py on the port's header ---------------------------------------

# representative classes (test_cpp_sdk.py's), ahead of one case per golden vector
CASES = [
    wire.Ident, wire.MsgBase, wire.ObjectPropertyList, wire.ObjectRecordList,
    wire.RecordAddRowStruct, wire.ObjectRecordSwap, wire.ReqAccountLogin,
    wire.ServerInfoReport, wire.ReqAckPlayerMove, wire.AckConnectWorldResult,
    families.PackMysqlParam, families.PackSURLParam, families.ReqBuildOperate,
    families.BulletEvents, families.CameraControlEvents,
]
ALL = CASES + list(_collect())


class Gen:
    """test_cpp_sdk.py's deterministic field filler, on the port's classes."""

    def __init__(self):
        self.n = 0

    def value(self, ftype):
        self.n += 1
        i = self.n
        if isinstance(ftype, tuple):
            return [self.value(ftype[1]) for _ in range(2)]
        if isinstance(ftype, type) and issubclass(ftype, Message):
            return self.message(ftype)
        return {
            "int32": [5, -3, 0, 1 << 28][i % 4],
            "int64": [9, -1, 1 << 40][i % 3],
            "uint64": [0, 7, (1 << 62) + 3][i % 3],
            "bool": bool(i % 2),
            "enum": i % 3,
            "float": [0.5, -2.25, 100.125][i % 3],
            "double": [1.5, -3.25e10][i % 2],
            "bytes": f"b{i}".encode(),
            "string": f"s{i}",
        }[ftype]

    def message(self, cls):
        return cls(**{f[1]: self.value(f[2]) for f in cls.FIELDS})


@pytest.fixture(scope="module")
def sdk_bin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("torch_cppsdk")
    (d / "nfmsg.hpp").write_text(emit_header())
    (d / "main.cc").write_text(cpp_driver(ALL))
    exe = d / "roundtrip"
    # -O0: the header is byte-equal to the JAX package's, which
    # tests/test_cpp_sdk.py compiles at -O1 with the same warnings as errors
    r = subprocess.run(["g++", "-std=c++11", "-O0", "-Wall", "-Werror", "-I", str(d),
                        str(d / "main.cc"), "-o", str(exe)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return exe


def _through(exe, stream: bytes):
    return subprocess.run([str(exe)], input=stream, capture_output=True)


def test_cpp_roundtrip_byte_identical(sdk_bin):
    gen = Gen()
    stream = b"".join(frame(i, gen.message(cls).encode()) for i, cls in enumerate(CASES))
    r = _through(sdk_bin, stream)
    assert r.returncode == 0, r.returncode
    assert r.stdout == stream, "C++ decode->encode is not byte-identical"


def test_cpp_roundtrips_every_golden_vector(sdk_bin):
    """Every message's golden vector of the port's codec goes through the
    binary byte-equal."""
    index = {c.__name__: i for i, c in enumerate(ALL) if i >= len(CASES)}
    cases = golden_cases()
    assert len(cases) == len(index)
    stream = b"".join(frame(index[name], raw) for name, raw in cases)
    r = _through(sdk_bin, stream)
    assert r.returncode == 0, r.returncode
    assert r.stdout == stream


def test_cpp_tolerates_unknown_fields(sdk_bin):
    base = wire.Ident(svrid=4, index=2).encode()
    r = _through(sdk_bin, frame(0, base + bytes([15 << 3 | 0, 42])))
    assert r.returncode == 0
    assert r.stdout == frame(0, base)


def test_cpp_rejects_truncated_body(sdk_bin):
    r = _through(sdk_bin, frame(1, wire.MsgBase(msg_data=b"x" * 40).encode()[:-7]))
    assert r.returncode == 2


def test_cpp_wire_type_mismatch_stays_aligned(sdk_bin):
    body = bytes([1 << 3 | 2, 3]) + b"xyz" + wire.Ident(index=7).encode()
    r = _through(sdk_bin, frame(0, body))
    assert r.returncode == 0
    assert r.stdout == frame(0, wire.Ident(index=7).encode())


def test_cpp_varint_overlong_rejected(sdk_bin):
    assert _through(sdk_bin, frame(0, b"\x80" * 11 + b"\x01")).returncode == 2


def test_cpp_corrupt_header_is_error_not_stall(sdk_bin):
    import struct

    assert _through(sdk_bin, struct.pack(">HI", 0, 3) + b"xxxx").returncode == 5
