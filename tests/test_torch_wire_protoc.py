"""The port's proto2 codec (noahgameframe_tpu_torch/net/wire.py) against protoc.

tests/test_wire_protoc.py on the port: the reference's .proto files (at
``test_wire_protoc.PROTO_SRC``, with the same two authoring fixes) and
the port's own copy of the extension schema,
``noahgameframe_tpu_torch/net/nf_tpu_ext.proto``, go through the real
``protoc``; every message class the port's ``net/wire.py`` and
``net/wire_families.py`` declare has a protoc counterpart with the same
tags and wire types, and a fully populated instance round-trips both ways
byte-identically.  Without ``protoc`` or the reference protos the protoc
cases skip with the reason; the port's schema is byte-equal to the JAX
package's either way.
"""

import importlib
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import noahgameframe_tpu_torch.net.wire as wire
import noahgameframe_tpu_torch.net.wire_families as wire_families
from noahgameframe_tpu_torch.net.wire import Message
from test_wire_protoc import EXT_PROTO as JAX_EXT_PROTO
from test_wire_protoc import PB_MODULES, PROTO_FILES, PROTO_SRC, norm
from test_torch_parity import one_intra_op_thread  # noqa: F401

EXT_PROTO = (Path(__file__).resolve().parents[1] / "noahgameframe_tpu_torch" / "net"
             / "nf_tpu_ext.proto")


def test_ports_extension_schema_is_the_jax_packages():
    assert EXT_PROTO.read_bytes() == JAX_EXT_PROTO.read_bytes()


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    if shutil.which("protoc") is None:
        pytest.skip("protoc is not on PATH")
    if not PROTO_SRC.is_dir():
        pytest.skip(f"the reference protos are not at {PROTO_SRC}")
    out = tmp_path_factory.mktemp("torch_nfpb")
    for f in PROTO_FILES:
        shutil.copy(PROTO_SRC / f, out / f)
    share = (out / "NFMsgShare.proto").read_text()
    share = share.replace("\trequired string\t\tuser_id \t= 2;",
                          "\trequired string\t\tuser_name \t= 2;")
    i = share.find("message ReqSearchToShare")
    j = share.find("message ReqSearchToShare", i + 1)
    share = share[:j] + share[j:].replace("message ReqSearchToShare",
                                          "message ReqShareToStart", 1)
    (out / "NFMsgShare.proto").write_text(share)
    shutil.copy(EXT_PROTO, out / EXT_PROTO.name)
    r = subprocess.run(["protoc", "-I", str(out), "--python_out", str(out)]
                       + PROTO_FILES + [EXT_PROTO.name], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    # import this directory's generated modules, not ones an earlier test
    # of the session left in sys.modules
    saved = {m: sys.modules.pop(m) for m in PB_MODULES if m in sys.modules}
    sys.path.insert(0, str(out))
    try:
        mods = [importlib.import_module(m) for m in PB_MODULES]
    finally:
        sys.path.remove(str(out))
        for m in PB_MODULES:
            sys.modules.pop(m, None)
        sys.modules.update(saved)
    registry = {}

    def add(name, cls):
        registry.setdefault(name, cls)
        for nested in cls.DESCRIPTOR.nested_types:
            add(nested.name, getattr(cls, nested.name))

    for m in mods:
        for name in m.DESCRIPTOR.message_types_by_name:
            add(name, getattr(m, name))
    return registry


def wire_classes():
    seen = {}
    for mod in (wire, wire_families):
        for c in vars(mod).values():
            if isinstance(c, type) and issubclass(c, Message) and c is not Message:
                seen.setdefault(c.__name__, c)
    return sorted(seen.values(), key=lambda c: c.__name__)


def _is_msg(t) -> bool:
    return isinstance(t, type) and issubclass(t, Message)


class ValueGen:
    """Deterministic per-field values covering sign and size edges."""

    def __init__(self):
        self.n = 0

    def value(self, ftype, pdesc, pb_registry):
        self.n += 1
        i = self.n
        if isinstance(ftype, tuple):
            return [self.value(ftype[1], pdesc, pb_registry) for _ in range(3)]
        if _is_msg(ftype):
            return self.message(ftype, pb_registry)
        if ftype == "enum":
            vals = pdesc.enum_type.values
            return vals[i % len(vals)].number
        if ftype in ("int32", "int64"):
            return [7, -1, 0, 1 << 30, -(1 << 31)][i % 5]
        if ftype == "uint64":
            return [0, 9, (1 << 63) + 5][i % 3]
        if ftype == "bool":
            return bool(i % 2)
        if ftype == "float":
            return [0.0, 1.5, -2.25, 1024.125][i % 4]
        if ftype == "double":
            return [0.0, 3.141592653589793, -1e100][i % 3]
        if ftype in ("bytes", "string"):
            v = f"v{i}".encode()
            return v if ftype == "bytes" else v.decode()
        raise AssertionError(f"unhandled field type {ftype}")

    def message(self, cls, pb_registry):
        by_tag = {f.number: f for f in pb_registry[cls.__name__].DESCRIPTOR.fields}
        return cls(**{name: self.value(ftype, by_tag[tag], pb_registry)
                      for tag, name, ftype, _ in cls.FIELDS})


def assert_matches_pb(ours, pmsg):
    by_tag = {f.number: f for f in type(pmsg).DESCRIPTOR.fields}
    for tag, name, ftype, _ in ours.FIELDS:
        ov, pv = getattr(ours, name), getattr(pmsg, by_tag[tag].name)
        if isinstance(ftype, tuple):
            assert len(ov) == len(pv), (type(ours).__name__, name)
            for o, p in zip(ov, pv):
                if _is_msg(ftype[1]):
                    assert_matches_pb(o, p)
                elif ftype[1] == "float":
                    assert abs(o - p) < 1e-6
                else:
                    assert norm(o) == norm(p), (type(ours).__name__, name)
        elif _is_msg(ftype):
            if ov is not None:
                assert_matches_pb(ov, pv)
        elif ftype == "float":
            assert abs(ov - pv) < 1e-6, (type(ours).__name__, name)
        else:
            assert norm(ov) == norm(pv), (type(ours).__name__, name, ov, pv)


def assert_same_fields(a, b):
    assert type(a) is type(b)
    for _, name, ftype, _ in a.FIELDS:
        av, bv = getattr(a, name), getattr(b, name)
        if isinstance(ftype, tuple):
            assert len(av) == len(bv)
            for x, y in zip(av, bv):
                if _is_msg(ftype[1]):
                    assert_same_fields(x, y)
                elif ftype[1] == "float":
                    assert abs(x - y) < 1e-6
                else:
                    assert norm(x) == norm(y), (type(a).__name__, name)
        elif _is_msg(ftype):
            if av is None:
                assert bv is None or not bv.encode()
            else:
                assert_same_fields(av, bv)
        elif ftype == "float":
            assert abs(av - bv) < 1e-6
        else:
            assert norm(av) == norm(bv), (type(a).__name__, name, av, bv)


def test_every_wire_message_has_protoc_counterpart(pb):
    assert [c.__name__ for c in wire_classes() if c.__name__ not in pb] == []


def test_field_tags_and_wire_types_match_protoc(pb):
    from google.protobuf.descriptor import FieldDescriptor as FD

    wt_of = {
        FD.TYPE_INT32: 0, FD.TYPE_INT64: 0, FD.TYPE_UINT32: 0,
        FD.TYPE_UINT64: 0, FD.TYPE_BOOL: 0, FD.TYPE_ENUM: 0,
        FD.TYPE_FLOAT: 5, FD.TYPE_FIXED32: 5, FD.TYPE_DOUBLE: 1,
        FD.TYPE_FIXED64: 1, FD.TYPE_STRING: 2, FD.TYPE_BYTES: 2,
        FD.TYPE_MESSAGE: 2,
    }
    for c in wire_classes():
        by_tag = {f.number: f for f in pb[c.__name__].DESCRIPTOR.fields}
        for tag, name, ftype, _ in c.FIELDS:
            assert tag in by_tag, (c.__name__, name)
            inner = ftype[1] if isinstance(ftype, tuple) else ftype
            owt = 2 if isinstance(inner, type) else wire._WIRE_TYPE[inner]
            assert owt == wt_of[by_tag[tag].type], (c.__name__, name, tag)


def test_roundtrip_every_message_both_directions(pb):
    gen = ValueGen()
    for c in wire_classes():
        ours = gen.message(c, pb)
        our_bytes = ours.encode()
        pmsg = pb[c.__name__]()
        pmsg.ParseFromString(our_bytes)
        assert_matches_pb(ours, pmsg)
        p_bytes = pmsg.SerializeToString()
        assert our_bytes == p_bytes, f"{c.__name__}: encoding not byte-identical"
        assert_same_fields(ours, c.decode(p_bytes))


def test_record_sync_messages_with_vector_lists(pb):
    gen = ValueGen()
    for name in ("ObjectRecordSwap", "RecordAddRowStruct", "ObjectRecordAddRow",
                 "ObjectRecordRemove", "ObjectRecordVector2", "ObjectRecordVector3"):
        ours = gen.message(getattr(wire, name), pb)
        pmsg = pb[name]()
        pmsg.ParseFromString(ours.encode())
        assert ours.encode() == pmsg.SerializeToString()
