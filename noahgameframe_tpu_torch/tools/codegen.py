"""The config codegen pipeline — NFFileProcess re-imagined.

Reference: `NFTools/NFFileProcess` turns Excel workbooks into Struct XML
+ Ini XML + `NFProtocolDefine.{hpp,java,cs}` + `NFrame.sql`
(`FileProcess.h:38-72` lists every emitter), and `GenerateConfigXML.sh`
runs it and copies configs into `_Out/NFDataCfg`.

This pipeline accepts CSV or XLSX class sheets and emits:
- ``Struct/LogicClass.xml`` + ``Struct/Class/<name>.xml`` in the exact
  reference format (`core.schema.load_logic_class_xml` round-trips it);
- ``Ini/<class>.xml`` instance files (`ElementStore.load_instance_xml``
  round-trips those);
- ``proto_define.py`` — the NFProtocolDefine equivalent: one namespace
  class per entity class with property/record name constants, so game
  code writes ``NF.Player.HP`` instead of bare strings;
- ``NFrame.sql`` via ``persist.sql.emit_ddl``.

Sheet layout (CSV sections / XLSX sheets):
- ``class`` row: ``name``,``parent``
- ``property`` table: Name,Type,Public,Private,Save,Cache,Ref,Upload,Desc
- ``record:<RecName>`` table header carries rows/flags; body lists
  Tag,Type columns
- ``components`` table: Name,Language

A copy of ``noahgameframe_tpu/tools/codegen.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import io
import keyword
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from xml.dom import minidom

from ..core.datatypes import DataType
from ..core.schema import (
    ClassDef,
    ClassRegistry,
    ComponentDef,
    PropertyDef,
    RecordColDef,
    RecordDef,
)

_TYPE_NAME = {
    DataType.INT: "int",
    DataType.FLOAT: "float",
    DataType.STRING: "string",
    DataType.OBJECT: "object",
    DataType.VECTOR2: "vector2",
    DataType.VECTOR3: "vector3",
}
_NAME_TYPE = {v: k for k, v in _TYPE_NAME.items()}

_FLAGS = ("Public", "Private", "Save", "Cache", "Ref", "Upload")


def _truthy(v) -> bool:
    return str(v or "").strip().lower() in ("1", "true", "yes")


# =====================================================================
# Input: CSV / XLSX class sheets -> ClassDef
# =====================================================================


def _parse_sections(rows: List[List[str]]) -> Dict[str, List[List[str]]]:
    """Split a sheet into [section]-headed tables."""
    sections: Dict[str, List[List[str]]] = {}
    current: Optional[str] = None
    for row in rows:
        cells = ["" if c is None else str(c).strip() for c in row]
        if not any(cells):
            continue
        head = cells[0]
        if head.startswith("[") and head.endswith("]"):
            sec = head[1:-1].strip()
            if sec.lower().startswith("record:"):
                # keep the record's name case, lowercase only the tag
                current = "record:" + sec.split(":", 1)[1].strip()
            else:
                current = sec.lower()
            sections.setdefault(current, [])
            # section header rows may carry key=value pairs after the tag
            extras = [c for c in cells[1:] if c]
            if extras:
                sections[current].append(["__kv__", *extras])
            continue
        if current is not None:
            sections[current].append(cells)
    return sections


def _table(rows: List[List[str]]) -> List[Dict[str, str]]:
    """First non-kv row is the header; the rest map header->cell."""
    body = [r for r in rows if r and r[0] != "__kv__"]
    if not body:
        return []
    header = [h.strip() for h in body[0]]
    out = []
    for r in body[1:]:
        out.append({header[i]: (r[i] if i < len(r) else "")
                    for i in range(len(header)) if header[i]})
    return out


def _kv(rows: List[List[str]]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for r in rows:
        if r and r[0] == "__kv__":
            for cell in r[1:]:
                if "=" in cell:
                    k, _, v = cell.partition("=")
                    out[k.strip().lower()] = v.strip()
    return out


def _class_from_sections(
    sections: Dict[str, List[List[str]]], default_name: str
) -> ClassDef:
    meta = _kv(sections.get("class", []))
    for row in _table(sections.get("class", [])):
        meta.setdefault("name", row.get("name", ""))
        meta.setdefault("parent", row.get("parent", ""))
    name = meta.get("name") or default_name
    parent = meta.get("parent") or None

    props = []
    for row in _table(sections.get("property", [])):
        pname = row.get("Name", "").strip()
        if not pname:
            continue
        props.append(PropertyDef(
            name=pname,
            type=_NAME_TYPE[(row.get("Type") or "int").strip().lower()],
            public=_truthy(row.get("Public")),
            private=_truthy(row.get("Private")),
            save=_truthy(row.get("Save")),
            cache=_truthy(row.get("Cache")),
            ref=_truthy(row.get("Ref")),
            upload=_truthy(row.get("Upload")),
            desc=row.get("Desc", ""),
        ))

    records = []
    for key, rows in sections.items():
        if not key.startswith("record:"):
            continue
        rname = key.split(":", 1)[1].strip()
        meta_r = _kv(rows)
        cols = tuple(
            RecordColDef(tag=row["Tag"].strip(),
                         type=_NAME_TYPE[(row.get("Type") or "int").strip().lower()])
            for row in _table(rows)
            if row.get("Tag", "").strip()
        )
        records.append(RecordDef(
            name=rname,
            max_rows=int(meta_r.get("rows", "1")),
            cols=cols,
            public=_truthy(meta_r.get("public")),
            private=_truthy(meta_r.get("private")),
            save=_truthy(meta_r.get("save")),
            cache=_truthy(meta_r.get("cache")),
            upload=_truthy(meta_r.get("upload")),
        ))

    comps = [
        ComponentDef(name=row.get("Name", ""),
                     language=row.get("Language", "python"))
        for row in _table(sections.get("components", []))
        if row.get("Name", "").strip()
    ]
    return ClassDef(name=name, parent=parent, properties=props,
                    records=records, components=comps,
                    instance_path=meta.get("instancepath", ""))


def load_class_csv(path: Path) -> ClassDef:
    """One CSV file -> ClassDef (sections per module docstring)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return _class_from_sections(_parse_sections(rows), Path(path).stem)


def load_class_xlsx(path: Path) -> List[ClassDef]:
    """One workbook -> ClassDefs (one sheet per class; each sheet uses
    the same [section] layout in column A)."""
    from .xlsx import read_xlsx_sheets

    out = []
    for sheet_name, rows in read_xlsx_sheets(path).items():
        str_rows = [["" if c is None else str(c) for c in r] for r in rows]
        out.append(_class_from_sections(_parse_sections(str_rows), sheet_name))
    return out


# =====================================================================
# Output: reference-format Struct XML
# =====================================================================


def _pretty(elem: ET.Element) -> str:
    raw = ET.tostring(elem, encoding="unicode")
    return minidom.parseString(raw).toprettyxml(indent="    ")


def _flags_attrs(d) -> Dict[str, str]:
    return {f: ("1" if d.flag(f.lower()) else "0") for f in _FLAGS
            if hasattr(d, f.lower())}


def emit_class_xml(cdef: ClassDef) -> str:
    root = ET.Element("XML")
    props = ET.SubElement(root, "Propertys")
    for p in cdef.properties:
        ET.SubElement(props, "Property", {
            "Id": p.name,
            "Type": _TYPE_NAME[p.type],
            **_flags_attrs(p),
            **({"Desc": p.desc} if p.desc else {}),
        })
    recs = ET.SubElement(root, "Records")
    for r in cdef.records:
        rec_el = ET.SubElement(recs, "Record", {
            "Id": r.name,
            "Row": str(r.max_rows),
            "Col": str(len(r.cols)),
            **{f: ("1" if r.flag(f.lower()) else "0")
               for f in ("Public", "Private", "Save", "Cache", "Upload")},
        })
        for c in r.cols:
            ET.SubElement(rec_el, "Col",
                          {"Tag": c.tag, "Type": _TYPE_NAME[c.type]})
    comps = ET.SubElement(root, "Components")
    for c in cdef.components:
        ET.SubElement(comps, "Component", {
            "Name": c.name, "Language": c.language,
            "Enable": "1" if c.enable else "0",
        })
    return _pretty(root)


def emit_logic_class_xml(
    registry: ClassRegistry, out_root: Path,
    root_class: str = "IObject",
) -> List[Path]:
    """Write Struct/LogicClass.xml + Struct/Class/<name>.xml mirroring the
    reference layout; returns written paths."""
    out_root = Path(out_root)
    struct = out_root / "Struct"
    class_dir = struct / "Class"
    class_dir.mkdir(parents=True, exist_ok=True)
    written: List[Path] = []

    children: Dict[Optional[str], List[str]] = {}
    for name in registry.names():
        children.setdefault(registry.get_def(name).parent, []).append(name)

    def class_el(parent_el: ET.Element, name: str) -> None:
        cdef = registry.get_def(name)
        el = ET.SubElement(parent_el, "Class", {
            "Id": name,
            "Path": f"Struct/Class/{name}.xml",
            **({"InstancePath": cdef.instance_path}
               if cdef.instance_path else {}),
        })
        p = class_dir / f"{name}.xml"
        p.write_text(emit_class_xml(cdef))
        written.append(p)
        for child in children.get(name, []):
            class_el(el, child)

    root = ET.Element("XML")
    for top in children.get(None, []):
        class_el(root, top)
    emitted = {p.stem for p in written}
    missing = [n for n in registry.names() if n not in emitted]
    if missing:
        raise ValueError(
            f"classes {missing} unreachable from a root class — missing "
            "parent definition or a parent cycle"
        )
    logic = struct / "LogicClass.xml"
    logic.write_text(_pretty(root))
    written.append(logic)
    return written


def emit_instance_xml(
    elements: Sequence[Dict[str, str]], out_path: Path
) -> Path:
    """Rows of {Id, prop: value} -> reference Ini XML."""
    root = ET.Element("XML")
    for row in elements:
        ET.SubElement(root, "Object",
                      {k: str(v) for k, v in row.items() if v is not None})
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(_pretty(root))
    return out_path


# =====================================================================
# Output: name-constant module (NFProtocolDefine equivalent)
# =====================================================================


_PY_KEYWORDS = frozenset(keyword.kwlist)


def _py_ident(name: str) -> str:
    return _sanitize_ident(name, _PY_KEYWORDS)


def emit_name_constants(registry: ClassRegistry) -> str:
    """Python module text: one class per entity class, string constants
    per property/record (+ record column indices), mirroring
    `NFProtocolDefine.hpp`'s `NFrame::Player::HP()` bindings."""
    out = io.StringIO()
    out.write('"""GENERATED name constants — do not edit by hand.\n\n')
    out.write("Regenerate with scripts/codegen.py (the NFProtocolDefine\n")
    out.write("equivalent of the reference codegen).\n"
              '"""\n\n')
    for name in registry.names():
        flat = registry._flatten(name)
        out.write(f"\nclass {_py_ident(name)}:\n")
        out.write(f'    ThisName = "{name}"\n')
        for p in flat.properties:
            out.write(f'    {_py_ident(p.name)} = "{p.name}"\n')
        for r in flat.records:
            rid = _py_ident(r.name)
            out.write(f"\n    class R_{rid}:\n")
            out.write(f'        ThisName = "{r.name}"\n')
            out.write(f"        MaxRows = {r.max_rows}\n")
            for i, c in enumerate(r.cols):
                out.write(f"        Col_{_py_ident(c.tag)} = {i}\n")
    return out.getvalue()


_CS_KEYWORDS = {
    "abstract", "as", "base", "bool", "break", "byte", "case", "catch",
    "char", "checked", "class", "const", "continue", "decimal", "default",
    "delegate", "do", "double", "else", "enum", "event", "explicit",
    "extern", "false", "finally", "fixed", "float", "for", "foreach",
    "goto", "if", "implicit", "in", "int", "interface", "internal", "is",
    "lock", "long", "namespace", "new", "null", "object", "operator",
    "out", "override", "params", "private", "protected", "public",
    "readonly", "ref", "return", "sbyte", "sealed", "short", "sizeof",
    "stackalloc", "static", "string", "struct", "switch", "this", "throw",
    "true", "try", "typeof", "uint", "ulong", "unchecked", "unsafe",
    "ushort", "using", "virtual", "void", "volatile", "while",
}


def _sanitize_ident(name: str, keywords, used: Optional[set] = None) -> str:
    """Language-safe identifier; with `used`, also unique within that scope
    (distinct schema names like 'a-b' vs 'a_b' both sanitize to 'a_b' —
    emitting both would fail compilation)."""
    ident = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    if not ident or ident[0].isdigit() or ident in keywords:
        ident = "_" + ident
    if used is not None:
        base, n = ident, 2
        while ident in used:
            ident = f"{base}_{n}"
            n += 1
        used.add(ident)
    return ident


def _cs_ident(name: str, used: Optional[set] = None) -> str:
    return _sanitize_ident(name, _CS_KEYWORDS, used)


def emit_name_constants_cs(registry: ClassRegistry) -> str:
    """C# source text for the Unity client SDK: per-class name constants
    and record column indices in an `NFrame` namespace, matching the
    reference codegen's .cs emitter
    (NFTools/NFFileProcess FileProcess.h:38-72 emits NFProtocolDefine.cs
    alongside the .hpp/.java bindings)."""
    out = io.StringIO()
    out.write("// GENERATED name constants - do not edit by hand.\n")
    out.write("// Regenerate with scripts/codegen.py.\n\n")
    out.write("namespace NFrame\n{\n")
    top_used: set = set()
    for name in registry.names():
        flat = registry._flatten(name)
        cls = _cs_ident(name, top_used)
        # a member named like its enclosing type is a C# error (CS0542)
        used = {cls, "ThisName"}
        out.write(f"    public static class {cls}\n    {{\n")
        out.write(f'        public const string ThisName = "{name}";\n')
        for p in flat.properties:
            out.write(
                f'        public const string {_cs_ident(p.name, used)} = "{p.name}";\n'
            )
        for r in flat.records:
            rid = _cs_ident(f"R_{r.name}", used)
            rec_used = {"ThisName", "MaxRows"}
            out.write(f"\n        public static class {rid}\n        {{\n")
            out.write(f'            public const string ThisName = "{r.name}";\n')
            out.write(f"            public const int MaxRows = {r.max_rows};\n")
            for i, c in enumerate(r.cols):
                out.write(
                    f"            public const int "
                    f"{_cs_ident(f'Col_{c.tag}', rec_used)} = {i};\n"
                )
            out.write("        }\n")
        out.write("    }\n\n")
    out.write("}\n")
    return out.getvalue()


_JAVA_KEYWORDS = {
    "abstract", "assert", "boolean", "break", "byte", "case", "catch",
    "char", "class", "const", "continue", "default", "do", "double",
    "else", "enum", "extends", "final", "finally", "float", "for",
    "goto", "if", "implements", "import", "instanceof", "int",
    "interface", "long", "native", "new", "package", "private",
    "protected", "public", "return", "short", "static", "strictfp",
    "super", "switch", "synchronized", "this", "throw", "throws",
    "transient", "try", "void", "volatile", "while", "true", "false",
    "null", "_",  # `_` is a keyword as of Java 9
}


def _java_ident(name: str, used: Optional[set] = None) -> str:
    return _sanitize_ident(name, _JAVA_KEYWORDS, used)


def emit_name_constants_java(registry: ClassRegistry) -> str:
    """Java source for client bindings: per-class name constants + record
    column indices, the `NFProtocolDefine.java` output of the reference
    codegen (its _Out/NFDataCfg/proto/NFProtocolDefine.java artifact).

    Unlike the reference — which emits many top-level `public class`es in
    one file, which javac rejects — everything nests inside one
    `public final class NFProtocolDefine`, so the file actually compiles.
    """
    out = io.StringIO()
    out.write("// GENERATED name constants - do not edit by hand.\n")
    out.write("// Regenerate with scripts/codegen.py.\n\n")
    out.write("package nframe;\n\n")
    out.write("public final class NFProtocolDefine {\n")
    out.write("    private NFProtocolDefine() {}\n\n")
    top_used: set = {"NFProtocolDefine"}
    for name in registry.names():
        flat = registry._flatten(name)
        cls = _java_ident(name, top_used)
        used = {cls, "ThisName"}
        out.write(f"    public static final class {cls} {{\n")
        out.write(f"        private {cls}() {{}}\n")
        out.write(f'        public static final String ThisName = "{name}";\n')
        for p in flat.properties:
            out.write(
                f"        public static final String "
                f'{_java_ident(p.name, used)} = "{p.name}"; // {p.type.name}\n'
            )
        for r in flat.records:
            rid = _java_ident(f"R_{r.name}", used)
            rec_used = {rid, "ThisName", "MaxRows"}
            out.write(f"\n        public static final class {rid} {{\n")
            out.write(f"            private {rid}() {{}}\n")
            out.write(
                f'            public static final String ThisName = "{r.name}";\n'
            )
            out.write(
                f"            public static final int MaxRows = {r.max_rows};\n"
            )
            for i, c in enumerate(r.cols):
                out.write(
                    f"            public static final int "
                    f"{_java_ident(f'Col_{c.tag}', rec_used)} = {i};\n"
                )
            out.write("        }\n")
        out.write("    }\n\n")
    out.write("}\n")
    return out.getvalue()


# =====================================================================
# The pipeline (GenerateConfigXML.sh equivalent)
# =====================================================================


class CodegenPipeline:
    """in_dir (CSV/XLSX class sheets + <Class>.ini.csv element rows)
    -> out_dir (Struct XML, Ini XML, proto_define.py, NFrame.sql)."""

    def __init__(self, in_dir: Path, out_dir: Path) -> None:
        self.in_dir = Path(in_dir)
        self.out_dir = Path(out_dir)

    def run(self) -> Dict[str, List[str]]:
        registry = ClassRegistry()
        ini_files: List[Tuple[str, Path]] = []
        for p in sorted(self.in_dir.iterdir()):
            if p.suffixes[-2:] == [".ini", ".csv"]:
                ini_files.append((p.name[: -len(".ini.csv")], p))
            elif p.suffix == ".csv":
                registry.define(load_class_csv(p))
            elif p.suffix == ".xlsx":
                for cdef in load_class_xlsx(p):
                    registry.define(cdef)
        report: Dict[str, List[str]] = {"classes": registry.names()}

        # instance files first so InstancePath attributes are known before
        # the one-and-only Struct emit
        ini_out: List[str] = []
        for cname, path in ini_files:
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            out = emit_instance_xml(
                rows, self.out_dir / "Ini" / f"{cname}.xml"
            )
            ini_out.append(str(out))
            if cname in registry:
                cdef = registry.get_def(cname)
                if not cdef.instance_path:
                    cdef.instance_path = f"Ini/{cname}.xml"
        report["ini"] = ini_out

        written = emit_logic_class_xml(registry, self.out_dir)
        report["struct"] = [str(p) for p in written]

        consts = self.out_dir / "proto_define.py"
        consts.write_text(emit_name_constants(registry))
        cs = self.out_dir / "NFProtocolDefine.cs"
        cs.write_text(emit_name_constants_cs(registry))
        java = self.out_dir / "NFProtocolDefine.java"
        java.write_text(emit_name_constants_java(registry))
        report["constants"] = [str(consts), str(cs), str(java)]

        from ..persist.sql import emit_ddl

        sql = self.out_dir / "NFrame.sql"
        sql.write_text(emit_ddl(registry, registry.names()))
        report["sql"] = [str(sql)]
        return report
