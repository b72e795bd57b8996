"""The port's class schema and RC4 config reader
(noahgameframe_tpu_torch.core.schema, core.crypto) after
tests/test_schema.py and tests/test_crypto.py, and the port's XML class
loaders against the JAX package's.

The schema cases run on the port's copy of the fixtures' registry
(tests/test_torch_scene.py ``port_registry``).  The repo defines its
classes in code and writes them as reference-format XML with
``tools/codegen.emit_logic_class_xml``: every class of the game's
``standard_registry()`` and of the fixtures' ``base_registry()`` is
written so, loaded by both packages' ``load_logic_class_xml`` and compared
field by field (each definition, each compiled slot, record and flag
mask)."""

import dataclasses
import enum
import textwrap

import numpy as np
import pytest

from fixtures import base_registry
from noahgameframe_tpu.core.schema import load_logic_class_xml as jax_load_logic_class_xml
from noahgameframe_tpu.game.schema import standard_registry
from noahgameframe_tpu.tools.codegen import emit_logic_class_xml
from noahgameframe_tpu_torch.core import Bank, ClassDef, DataType, load_logic_class_xml
from noahgameframe_tpu_torch.core.crypto import (
    MAGIC,
    decrypt_config,
    encrypt_config,
    rc4,
    read_config_bytes,
)
from noahgameframe_tpu_torch.core.schema import load_class_xml
from test_torch_scene import port_registry
from test_torch_parity import one_intra_op_thread  # noqa: F401


def registry():
    return port_registry(base_registry())


# ------------------------------------------------ tests/test_schema.py
def test_inheritance_flattens_parent_first():
    spec = registry().spec("Player")
    assert spec.prop_order[:6] == (
        "ID", "ClassName", "SceneID", "GroupID", "ConfigID", "Position")
    assert "HP" in spec.prop_order
    assert spec.slots["SceneID"].prop.type == DataType.INT


def test_bank_compilation_partitions_by_dtype():
    spec = registry().spec("Player")
    for bank in Bank:
        cols = [s.col for s in spec.bank_props(bank)]
        assert cols == list(range(len(cols)))
    assert spec.n_i32 + spec.n_f32 + spec.n_vec == len(spec.prop_order)
    assert spec.slots["Name"].bank == Bank.I32
    assert spec.slots["FirstTarget"].bank == Bank.I32
    assert spec.slots["MoveSpeed"].bank == Bank.F32
    assert spec.slots["Position"].bank == Bank.VEC


def test_flag_masks():
    spec = registry().spec("Player")
    pub = spec.mask(Bank.I32, "public")
    sav = spec.mask(Bank.I32, "save")
    assert pub[spec.slots["HP"].col]
    assert not pub[spec.slots["Gold"].col]
    assert sav[spec.slots["Gold"].col]
    up = spec.mask(Bank.I32, "upload")
    assert up[spec.slots["Gold"].col] and up.sum() == 1
    assert not spec.mask(Bank.VEC, "upload")[spec.slots["Position"].col]
    assert spec.mask(Bank.VEC, "public")[spec.slots["Position"].col]


def test_record_spec():
    rs = registry().spec("Player").records["PlayerHero"]
    assert rs.max_rows == 8
    assert rs.col_order == ("GUID", "ConfigID", "Level", "Exp")
    assert rs.n_i32 == 4 and rs.n_f32 == 0
    assert rs.cols["Level"].bank == Bank.I32


def test_duplicate_class_rejected():
    with pytest.raises(ValueError):
        registry().define(ClassDef(name="Player"))


def test_load_reference_format_xml(tmp_path):
    (tmp_path / "Struct" / "Class").mkdir(parents=True)
    (tmp_path / "Struct" / "LogicClass.xml").write_text(textwrap.dedent("""\
        <XML>
          <Class Id="IObject" Path="Struct/Class/IObject.xml" InstancePath="">
            <Class Id="Mob" Path="Struct/Class/Mob.xml" InstancePath="Ini/Mob.xml"/>
          </Class>
        </XML>
        """))
    (tmp_path / "Struct" / "Class" / "IObject.xml").write_text(textwrap.dedent("""\
        <XML>
          <Propertys>
            <Property Id="ID" Type="string" Public="0" Private="1"/>
            <Property Id="SceneID" Type="int" Public="0" Private="1"/>
            <Property Id="X" Type="float" Public="1" Private="1" Save="1" Cache="1"/>
          </Propertys>
        </XML>
        """))
    (tmp_path / "Struct" / "Class" / "Mob.xml").write_text(textwrap.dedent("""\
        <XML>
          <Propertys>
            <Property Id="HP" Type="int" Public="1" Private="1" Save="1"/>
            <Property Id="Master" Type="object" Public="0"/>
          </Propertys>
          <Records>
            <Record Id="Drops" Row="4" Col="2" Public="0" Private="1" Save="1">
              <Col Type="string" Tag="ItemID"/>
              <Col Type="int" Tag="Count"/>
            </Record>
          </Records>
          <Components>
            <Component Name="AI" Language="python" Enable="1"/>
          </Components>
        </XML>
        """))
    reg = load_logic_class_xml(tmp_path / "Struct" / "LogicClass.xml", data_root=tmp_path)
    assert "Mob" in reg and "IObject" in reg
    spec = reg.spec("Mob")
    assert spec.prop_order == ("ID", "SceneID", "X", "HP", "Master")
    assert spec.slots["X"].prop.save and spec.slots["X"].prop.cache
    assert spec.records["Drops"].max_rows == 4
    flat = reg._flatten("Mob")
    assert flat.components[0].name == "AI"
    assert reg.get_def("Mob").instance_path == "Ini/Mob.xml"
    # one class file alone, as the loader reads it
    mob = load_class_xml(tmp_path / "Struct" / "Class" / "Mob.xml", "Mob", "IObject")
    assert [p.name for p in mob.properties] == ["HP", "Master"]
    assert mob.records[0].cols[1].type == DataType.INT


# ------------------------------------------------ tests/test_crypto.py
def test_rc4_known_vector():
    assert rc4(b"Key", b"Plaintext").hex() == "bbf316e8d940af0ad3"


def test_rc4_symmetry_and_magic():
    data = b"<xml>config</xml>" * 10
    enc = encrypt_config(data, "s3cret")
    assert enc.startswith(MAGIC) and enc != data
    assert decrypt_config(enc, "s3cret") == data
    assert decrypt_config(data, "s3cret") == data
    assert decrypt_config(data, None) == data
    with pytest.raises(ValueError):
        decrypt_config(enc, None)


def test_ciphered_logic_class_loads(tmp_path):
    (tmp_path / "NFDataCfg" / "Struct" / "Class").mkdir(parents=True)
    logic = tmp_path / "NFDataCfg" / "Struct" / "LogicClass.xml"
    cls = tmp_path / "NFDataCfg" / "Struct" / "Class" / "Thing.xml"
    cls_xml = ("<XML><Propertys>"
               '<Property Id="HP" Type="int" Public="1"/>'
               "</Propertys><Records/><Components/></XML>")
    logic_xml = '<XML><Class Id="Thing" Path="NFDataCfg/Struct/Class/Thing.xml"/></XML>'
    logic.write_bytes(encrypt_config(logic_xml.encode(), "k1"))
    cls.write_bytes(encrypt_config(cls_xml.encode(), "k1"))
    reg = load_logic_class_xml(logic, cipher_key="k1")
    assert "Thing" in reg.names()
    assert [p.name for p in reg._flatten("Thing").properties] == ["HP"]
    logic.write_text(logic_xml)
    cls.write_text(cls_xml)
    assert "Thing" in load_logic_class_xml(logic).names()


def test_read_config_bytes(tmp_path):
    p = tmp_path / "x.xml"
    p.write_bytes(encrypt_config(b"<a/>", b"\x01\x02"))
    assert read_config_bytes(p, b"\x01\x02") == b"<a/>"


# ------------------------------------- the repo's classes, both loaders
def _plain(x):
    """A schema value as plain data: each package's enums by name."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _spec_view(spec, banks) -> dict:
    out = {
        "prop_order": list(spec.prop_order),
        "widths": [spec.n_i32, spec.n_f32, spec.n_vec],
        "slots": {n: (s.bank.name, s.col, _plain(s.prop)) for n, s in spec.slots.items()},
        "records": {n: (r.max_rows, list(r.col_order), r.n_i32, r.n_f32,
                        {c: (s.bank.name, s.col) for c, s in r.cols.items()})
                    for n, r in spec.records.items()},
    }
    for bank in banks:
        for flag in ("public", "private", "save", "cache", "ref", "upload"):
            out[f"mask/{bank.name}/{flag}"] = np.asarray(spec.mask(bank, flag)).tolist()
    return out


@pytest.mark.parametrize("source", ["standard_registry", "base_registry"])
def test_loaded_registry_equals_jax_field_by_field(source, tmp_path):
    from noahgameframe_tpu.core.datatypes import Bank as JBank

    reg = {"standard_registry": standard_registry, "base_registry": base_registry}[source]()
    emit_logic_class_xml(reg, tmp_path)
    logic = tmp_path / "Struct" / "LogicClass.xml"
    ref = jax_load_logic_class_xml(logic, data_root=tmp_path)
    got = load_logic_class_xml(logic, data_root=tmp_path)
    assert got.names() == ref.names() and set(got.names()) == set(reg.names())
    for name in ref.names():
        assert _plain(got.get_def(name)) == _plain(ref.get_def(name)), name
        assert _plain(got._flatten(name)) == _plain(ref._flatten(name)), name
        assert _spec_view(got.spec(name), Bank) == _spec_view(ref.spec(name), JBank), name
