"""Class schema: declarative entity shapes compiled to device bank layouts.

The reference drives everything from XML class schemas — a LogicClass.xml
tree of classes (inheritance by nesting, root `IObject`), each pointing at a
per-class XML with `<Property Id Type Public Private Save Cache Ref Upload>`
rows, `<Record Id Row Col ...><Col Type Tag/></Record>` tables and
`<Component>` entries (reference NFCClassModule.cpp:72-228, LogicClass.xml).

Here a schema has two lives:

1. Declarative (`PropertyDef`/`RecordDef`/`ClassDef`, `ClassRegistry`) —
   loaded from reference-format XML (`load_logic_class_xml`) or built
   programmatically (`prop`, `record`).  Inheritance is flattened
   parent-first, exactly like the reference's AddClassInclude chain.

2. Compiled (`ClassSpec`) — the TPU layout.  Every property becomes a column
   in one of three dtype-homogeneous banks (i32 / f32 / vec[3]), so a class
   with 80 properties is 3 device arrays, not 80, and flag-filtered diffing
   or checkpointing is a single masked compare per bank.  Records compile
   the same way with an extra rows axis.  Flags compile to per-bank boolean
   column masks (`ClassSpec.mask`).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .datatypes import (
    BANK_OF_TYPE,
    XML_TYPE_NAMES,
    Bank,
    DataType,
    Value,
    coerce,
    default_value,
)

FLAG_NAMES = ("public", "private", "save", "cache", "ref", "upload")


@dataclasses.dataclass(frozen=True)
class PropertyDef:
    name: str
    type: DataType
    public: bool = False
    private: bool = False
    save: bool = False
    cache: bool = False
    ref: bool = False
    upload: bool = False
    desc: str = ""
    default: Optional[Value] = None

    def flag(self, flag_name: str) -> bool:
        return bool(getattr(self, flag_name))

    def resolved_default(self) -> Value:
        return self.default if self.default is not None else default_value(self.type)


@dataclasses.dataclass(frozen=True)
class RecordColDef:
    tag: str
    type: DataType


@dataclasses.dataclass(frozen=True)
class RecordDef:
    name: str
    max_rows: int
    cols: Tuple[RecordColDef, ...]
    public: bool = False
    private: bool = False
    save: bool = False
    cache: bool = False
    upload: bool = False
    desc: str = ""

    def flag(self, flag_name: str) -> bool:
        return bool(getattr(self, flag_name, False))


@dataclasses.dataclass(frozen=True)
class ComponentDef:
    name: str
    language: str = "python"
    enable: bool = True
    desc: str = ""


@dataclasses.dataclass
class ClassDef:
    name: str
    parent: Optional[str] = None
    properties: List[PropertyDef] = dataclasses.field(default_factory=list)
    records: List[RecordDef] = dataclasses.field(default_factory=list)
    components: List[ComponentDef] = dataclasses.field(default_factory=list)
    instance_path: str = ""
    desc: str = ""


# ---------------------------------------------------------------------------
# Compiled layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PropertySlot:
    """Where one property lives on device: (bank, column)."""

    prop: PropertyDef
    bank: Bank
    col: int


@dataclasses.dataclass(frozen=True)
class RecordColSlot:
    col_def: RecordColDef
    bank: Bank
    col: int


@dataclasses.dataclass(frozen=True)
class RecordSpec:
    rec: RecordDef
    cols: Dict[str, RecordColSlot]
    col_order: Tuple[str, ...]
    n_i32: int
    n_f32: int
    n_vec: int

    @property
    def name(self) -> str:
        return self.rec.name

    @property
    def max_rows(self) -> int:
        return self.rec.max_rows


class ClassSpec:
    """Compiled, immutable device layout for one class."""

    def __init__(self, cls: ClassDef):
        self.cls = cls
        self.name = cls.name
        self.slots: Dict[str, PropertySlot] = {}
        self.prop_order: Tuple[str, ...] = tuple(p.name for p in cls.properties)
        if len(set(self.prop_order)) != len(self.prop_order):
            dupes = [n for n in self.prop_order if self.prop_order.count(n) > 1]
            raise ValueError(f"class {cls.name!r} has duplicate properties: {sorted(set(dupes))}")
        counters = {Bank.I32: 0, Bank.F32: 0, Bank.VEC: 0}
        for p in cls.properties:
            bank = BANK_OF_TYPE[p.type]
            self.slots[p.name] = PropertySlot(p, bank, counters[bank])
            counters[bank] += 1
        self.n_i32 = counters[Bank.I32]
        self.n_f32 = counters[Bank.F32]
        self.n_vec = counters[Bank.VEC]

        self.records: Dict[str, RecordSpec] = {}
        self.record_order: Tuple[str, ...] = tuple(r.name for r in cls.records)
        for r in cls.records:
            rc = {Bank.I32: 0, Bank.F32: 0, Bank.VEC: 0}
            cols: Dict[str, RecordColSlot] = {}
            for c in r.cols:
                bank = BANK_OF_TYPE[c.type]
                cols[c.tag] = RecordColSlot(c, bank, rc[bank])
                rc[bank] += 1
            self.records[r.name] = RecordSpec(
                rec=r,
                cols=cols,
                col_order=tuple(c.tag for c in r.cols),
                n_i32=rc[Bank.I32],
                n_f32=rc[Bank.F32],
                n_vec=rc[Bank.VEC],
            )

        self._mask_cache: Dict[Tuple[Bank, str], np.ndarray] = {}

    def slot(self, prop_name: str) -> PropertySlot:
        try:
            return self.slots[prop_name]
        except KeyError:
            raise KeyError(f"class {self.name!r} has no property {prop_name!r}") from None

    def has_property(self, prop_name: str) -> bool:
        return prop_name in self.slots

    def bank_size(self, bank: Bank) -> int:
        return {Bank.I32: self.n_i32, Bank.F32: self.n_f32, Bank.VEC: self.n_vec}[bank]

    def bank_props(self, bank: Bank) -> List[PropertySlot]:
        out = [s for s in self.slots.values() if s.bank == bank]
        out.sort(key=lambda s: s.col)
        return out

    def mask(self, bank: Bank, flag_name: str) -> np.ndarray:
        """Boolean column mask for a flag over one bank, e.g. which i32
        columns are Public.  This is how the reference's per-property flag
        checks (NFCProperty.h:17-94) become vectorised column selects."""
        key = (bank, flag_name)
        m = self._mask_cache.get(key)
        if m is None:
            m = np.zeros(self.bank_size(bank), dtype=bool)
            for s in self.bank_props(bank):
                m[s.col] = s.prop.flag(flag_name)
            m.setflags(write=False)
            self._mask_cache[key] = m
        return m

    def string_cols_i32(self) -> List[int]:
        """i32 columns that hold interned string handles (host decode aid)."""
        return [s.col for s in self.bank_props(Bank.I32) if s.prop.type == DataType.STRING]

    def object_cols_i32(self) -> List[int]:
        return [s.col for s in self.bank_props(Bank.I32) if s.prop.type == DataType.OBJECT]


# ---------------------------------------------------------------------------
# Registry with inheritance flattening
# ---------------------------------------------------------------------------


class ClassRegistry:
    """Holds ClassDefs, resolves inheritance, hands out compiled ClassSpecs.

    Inheritance mirrors the reference: children get the parent's properties,
    records and components prepended (parent-first), transitively up to the
    root (reference NFCClassModule.cpp:230-320)."""

    def __init__(self) -> None:
        self._defs: Dict[str, ClassDef] = {}
        self._specs: Dict[str, ClassSpec] = {}

    def define(self, cls: ClassDef) -> ClassDef:
        if cls.name in self._defs:
            raise ValueError(f"class {cls.name!r} already defined")
        self._defs[cls.name] = cls
        self._specs.pop(cls.name, None)
        return cls

    def __contains__(self, name: str) -> bool:
        return name in self._defs

    def names(self) -> List[str]:
        return list(self._defs)

    def get_def(self, name: str) -> ClassDef:
        return self._defs[name]

    def _flatten(self, name: str, _seen: Optional[set] = None) -> ClassDef:
        seen = _seen or set()
        if name in seen:
            raise ValueError(f"inheritance cycle at {name!r}")
        seen.add(name)
        cls = self._defs[name]
        if not cls.parent:
            return cls
        parent = self._flatten(cls.parent, seen)
        # dict insertion order gives parent-first layout; child overrides
        # replace the parent's definition in place.
        merged_props: Dict[str, PropertyDef] = {p.name: p for p in parent.properties}
        merged_props.update({p.name: p for p in cls.properties})
        merged_recs: Dict[str, RecordDef] = {r.name: r for r in parent.records}
        merged_recs.update({r.name: r for r in cls.records})
        merged_comps: Dict[str, ComponentDef] = {c.name: c for c in parent.components}
        merged_comps.update({c.name: c for c in cls.components})
        return ClassDef(
            name=cls.name,
            parent=None,
            properties=list(merged_props.values()),
            records=list(merged_recs.values()),
            components=list(merged_comps.values()),
            instance_path=cls.instance_path,
            desc=cls.desc,
        )

    def spec(self, name: str) -> ClassSpec:
        s = self._specs.get(name)
        if s is None:
            s = ClassSpec(self._flatten(name))
            self._specs[name] = s
        return s


# ---------------------------------------------------------------------------
# Reference-format XML loading
# ---------------------------------------------------------------------------


def _flag(elem: ET.Element, attr: str) -> bool:
    return elem.get(attr, "0").strip() in ("1", "true", "True")


def _parse_property(elem: ET.Element) -> PropertyDef:
    t = XML_TYPE_NAMES[elem.get("Type", "int").lower()]
    return PropertyDef(
        name=elem.get("Id", ""),
        type=t,
        public=_flag(elem, "Public"),
        private=_flag(elem, "Private"),
        save=_flag(elem, "Save"),
        cache=_flag(elem, "Cache"),
        ref=_flag(elem, "Ref"),
        upload=_flag(elem, "Upload"),
        desc=elem.get("Desc", ""),
    )


def _parse_record(elem: ET.Element) -> RecordDef:
    cols = tuple(
        RecordColDef(tag=c.get("Tag", f"col{i}"), type=XML_TYPE_NAMES[c.get("Type", "int").lower()])
        for i, c in enumerate(elem.findall("Col"))
    )
    # the reference trusts the <Col> children over the declared Col count
    return RecordDef(
        name=elem.get("Id", ""),
        max_rows=int(elem.get("Row", "1")),
        cols=cols,
        public=_flag(elem, "Public"),
        private=_flag(elem, "Private"),
        save=_flag(elem, "Save"),
        cache=_flag(elem, "Cache"),
        upload=_flag(elem, "Upload"),
        desc=elem.get("Desc", ""),
    )


def load_class_xml(path: Path, name: str, parent: Optional[str], instance_path: str = "",
                   cipher_key=None) -> ClassDef:
    """Parse one per-class XML (Propertys/Records/Components sections).
    RC4-ciphered files (core/crypto.py NFRC4 convention; reference myrc4)
    decrypt transparently when `cipher_key` is given."""
    from .crypto import read_config_bytes

    root = ET.fromstring(read_config_bytes(path, cipher_key))
    props = [_parse_property(p) for p in root.findall("./Propertys/Property")]
    recs = [_parse_record(r) for r in root.findall("./Records/Record")]
    comps = [
        ComponentDef(
            name=c.get("Name", ""),
            language=c.get("Language", "python"),
            enable=_flag(c, "Enable"),
            desc=c.get("Desc", ""),
        )
        for c in root.findall("./Components/Component")
    ]
    return ClassDef(
        name=name,
        parent=parent,
        properties=props,
        records=recs,
        components=comps,
        instance_path=instance_path,
    )


def load_logic_class_xml(logic_class_path: Path, data_root: Optional[Path] = None,
                         cipher_key=None) -> ClassRegistry:
    """Load a reference-format LogicClass.xml class tree.

    `Path`/`InstancePath` attributes are resolved relative to `data_root`
    (defaults to the directory containing the parent of LogicClass.xml, i.e.
    the directory that paths like "NFDataCfg/Struct/Class/X.xml" are
    relative to in the reference layout)."""
    logic_class_path = Path(logic_class_path)
    if data_root is None:
        # .../NFDataCfg/Struct/LogicClass.xml -> data_root = .../
        data_root = logic_class_path.parent.parent.parent
    registry = ClassRegistry()

    def walk(elem: ET.Element, parent: Optional[str]) -> None:
        name = elem.get("Id", "")
        rel = elem.get("Path", "")
        inst = elem.get("InstancePath", "")
        cls_path = data_root / rel if rel else None
        if cls_path is not None and cls_path.exists():
            cls = load_class_xml(cls_path, name, parent, inst, cipher_key=cipher_key)
        else:
            cls = ClassDef(name=name, parent=parent, instance_path=inst)
        registry.define(cls)
        for child in elem.findall("Class"):
            walk(child, name)

    from .crypto import read_config_bytes

    root = ET.fromstring(read_config_bytes(logic_class_path, cipher_key))
    for top in root.findall("Class"):
        walk(top, None)
    return registry


# ---------------------------------------------------------------------------
# Convenience builders (programmatic schema definition)
# ---------------------------------------------------------------------------


def prop(name: str, type_name: str, *, default: Optional[Value] = None, **flags) -> PropertyDef:
    t = XML_TYPE_NAMES[type_name.lower()]
    d = None if default is None else coerce(t, default)
    return PropertyDef(name=name, type=t, default=d, **flags)


def record(name: str, max_rows: int, cols: Sequence[Tuple[str, str]], **flags) -> RecordDef:
    return RecordDef(
        name=name,
        max_rows=max_rows,
        cols=tuple(RecordColDef(tag=t, type=XML_TYPE_NAMES[ty.lower()]) for t, ty in cols),
        **flags,
    )
