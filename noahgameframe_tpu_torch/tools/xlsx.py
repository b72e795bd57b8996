"""Minimal read-only .xlsx sheet reader (stdlib only).

The reference's NFFileProcess vendors MiniExcelReader to pull schema
sheets out of Excel workbooks (`NFTools/NFFileProcess/`).  An .xlsx is a
zip of XML parts; this reads sharedStrings + each worksheet into rows of
python values without external dependencies (openpyxl is not in the
image).  Supports inline/shared strings and numbers — the subset schema
workbooks use.

A copy of ``noahgameframe_tpu/tools/xlsx.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Union

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
_REL_NS = {
    "r": "http://schemas.openxmlformats.org/package/2006/relationships"
}

Cell = Union[str, int, float, None]


def _col_index(ref: str) -> int:
    """'C7' -> 2 (zero-based column)."""
    m = re.match(r"([A-Z]+)", ref or "A")
    n = 0
    for ch in m.group(1):
        n = n * 26 + (ord(ch) - ord("A") + 1)
    return n - 1


def _cell_value(c: ET.Element, shared: List[str]) -> Cell:
    t = c.get("t", "n")
    v = c.find("m:v", _NS)
    if t == "inlineStr":
        is_el = c.find("m:is", _NS)
        return "".join(
            t_el.text or "" for t_el in is_el.iter(
                "{%s}t" % _NS["m"]
            )
        ) if is_el is not None else None
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t == "str":
        return v.text
    if t == "b":
        return int(v.text)
    # numeric: keep ints integral
    txt = v.text
    try:
        f = float(txt)
        return int(f) if f.is_integer() else f
    except ValueError:
        return txt


def read_xlsx_sheets(path: Path) -> Dict[str, List[List[Cell]]]:
    """Workbook -> {sheet_name: rows}; rows are padded to ragged width."""
    path = Path(path)
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append(
                    "".join(t.text or "" for t in si.iter("{%s}t" % _NS["m"]))
                )
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        rels = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        rel_target = {
            r.get("Id"): r.get("Target") for r in rels.findall("r:Relationship", _REL_NS)
        }
        out: Dict[str, List[List[Cell]]] = {}
        rid_attr = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
                    "relationships}id")
        for sheet in wb.findall("m:sheets/m:sheet", _NS):
            name = sheet.get("name", "Sheet")
            target = rel_target.get(sheet.get(rid_attr), "")
            if not target:
                continue
            member = "xl/" + target.lstrip("/").removeprefix("xl/")
            ws = ET.fromstring(z.read(member))
            rows: List[List[Cell]] = []
            for row in ws.findall("m:sheetData/m:row", _NS):
                cells: List[Cell] = []
                for c in row.findall("m:c", _NS):
                    idx = _col_index(c.get("r", ""))
                    while len(cells) < idx:
                        cells.append(None)
                    cells.append(_cell_value(c, shared))
                rows.append(cells)
            out[name] = rows
    return out


def write_xlsx(path: Path, sheets: Dict[str, List[List[Cell]]]) -> None:
    """Tiny writer (inline strings only) — lets tests build workbooks and
    deployments hand-edit schema sheets without Excel."""
    from xml.sax.saxutils import escape

    def col_ref(i: int) -> str:
        s = ""
        i += 1
        while i:
            i, r = divmod(i - 1, 26)
            s = chr(ord("A") + r) + s
        return s

    sheet_xmls = []
    for rows in sheets.values():
        body = []
        for r_i, row in enumerate(rows, start=1):
            cells = []
            for c_i, val in enumerate(row):
                if val is None:
                    continue
                ref = f"{col_ref(c_i)}{r_i}"
                if isinstance(val, (int, float)) and not isinstance(val, bool):
                    cells.append(f'<c r="{ref}"><v>{val}</v></c>')
                else:
                    cells.append(
                        f'<c r="{ref}" t="inlineStr"><is><t>'
                        f"{escape(str(val))}</t></is></c>"
                    )
            body.append(f'<row r="{r_i}">' + "".join(cells) + "</row>")
        sheet_xmls.append(
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            f'<worksheet xmlns="{_NS["m"]}"><sheetData>'
            + "".join(body)
            + "</sheetData></worksheet>"
        )

    names = [escape(n, {'"': "&quot;"}) for n in sheets]
    wb = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<workbook xmlns="{_NS["m"]}" xmlns:r='
        '"http://schemas.openxmlformats.org/officeDocument/2006/relationships"'
        "><sheets>"
        + "".join(
            f'<sheet name="{n}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
            for i, n in enumerate(names)
        )
        + "</sheets></workbook>"
    )
    rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns='
        '"http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
            "openxmlformats.org/officeDocument/2006/relationships/worksheet"
            f'" Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(len(names))
        )
        + "</Relationships>"
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns='
        '"http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns='
        '"http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        + "".join(
            f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
            'ContentType="application/vnd.openxmlformats-officedocument.'
            'spreadsheetml.worksheet+xml"/>'
            for i in range(len(names))
        )
        + "</Types>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", wb)
        z.writestr("xl/_rels/workbook.xml.rels", rels)
        for i, xml in enumerate(sheet_xmls):
            z.writestr(f"xl/worksheets/sheet{i + 1}.xml", xml)
