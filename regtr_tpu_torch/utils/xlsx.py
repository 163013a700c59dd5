"""A one-sheet .xlsx writer and reader with no package beyond the standard
library (the port's own copy of regtr_tpu/utils/xlsx.py; a CPU test holds
the files' rows equal both ways).

`evaluate_3dmatch` writes its per-pair errors as ``individual_errors.xlsx``,
as the upstream script does through pandas.  An .xlsx file is a ZIP of five
small XML parts, written here directly: one sheet of str / int / float /
bool cells, readable by Excel, LibreOffice and openpyxl.
"""
from __future__ import annotations

import math
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    "</Relationships>"
)

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
    'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
    '<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets></workbook>'
)

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
    "</Relationships>"
)


def _col_name(idx: int) -> str:
    """0-based column index -> spreadsheet column letters (0 -> A)."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _cell_xml(ref: str, value) -> str:
    if isinstance(value, bool):  # before int: bool is an int subclass
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        if isinstance(value, float) and not math.isfinite(value):
            return f'<c r="{ref}"/>'  # NaN/inf: no valid xlsx numeric
            # encoding exists; emit a blank cell
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'


def write_xlsx(path, rows, sheet_name: str = "Sheet1") -> None:
    """Write ``rows`` (iterable of cell sequences) as a one-sheet .xlsx."""
    body = []
    for r, row in enumerate(rows, start=1):
        cells = "".join(
            _cell_xml(f"{_col_name(c)}{r}", v) for c, v in enumerate(row)
        )
        body.append(f'<row r="{r}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f'<sheetData>{"".join(body)}</sheetData></worksheet>'
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", _CONTENT_TYPES)
        zf.writestr("_rels/.rels", _ROOT_RELS)
        zf.writestr("xl/workbook.xml",
                    _WORKBOOK.format(name=escape(sheet_name)))
        zf.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        zf.writestr("xl/worksheets/sheet1.xml", sheet)


def read_xlsx(path):
    """Read back a one-sheet .xlsx written by :func:`write_xlsx`: a list of
    rows, numeric cells as float."""
    import xml.etree.ElementTree as ET

    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as zf:
        root = ET.fromstring(zf.read("xl/worksheets/sheet1.xml"))
    out = []
    for row in root.iter(f"{ns}row"):
        vals = []
        for cell in row.iter(f"{ns}c"):
            kind = cell.get("t", "n")
            if kind == "inlineStr":
                t = cell.find(f"{ns}is/{ns}t")
                vals.append("" if t is None else t.text or "")
            else:
                v = cell.find(f"{ns}v")
                text = "" if v is None else v.text or ""
                if not text:
                    vals.append(float("nan"))  # blank numeric cell
                else:
                    vals.append(bool(int(text)) if kind == "b"
                                else float(text))
        out.append(vals)
    return out
