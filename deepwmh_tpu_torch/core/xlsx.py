"""Minimal xlsx read/write with no external dependency (the port's copy of
``deepwmh_tpu.core.xlsx``; a workbook either package writes reads back the
same in the other).

The blinded visual-scoring harness (``eval/stats.py``) reads and writes
xlsx score sheets. This implements the small subset it needs without
openpyxl: one or more sheets of scalar cells (strings and numbers), written
as an Office Open XML package (a zip of XML parts) and read back through
the shared-strings table.
"""

from __future__ import annotations

import re
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/sharedStrings.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sharedStrings+xml"/>
%s
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""


def _col_name(idx: int) -> str:
    """0-based column index -> A, B, ..., Z, AA, ..."""
    name = ""
    idx += 1
    while idx > 0:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def write_xlsx(path: str, sheets: dict) -> None:
    """sheets: {sheet_name: list of rows, each row a list of str/num/None}."""
    shared = []
    shared_idx = {}

    def sstr(s):
        if s not in shared_idx:
            shared_idx[s] = len(shared)
            shared.append(s)
        return shared_idx[s]

    sheet_xmls = []
    for rows in sheets.values():
        parts = ["<sheetData>"]
        for r, row in enumerate(rows, start=1):
            parts.append('<row r="%d">' % r)
            for c, val in enumerate(row):
                if val is None or val == "":
                    continue
                ref = "%s%d" % (_col_name(c), r)
                if isinstance(val, (int, float)) and not isinstance(val, bool):
                    parts.append('<c r="%s"><v>%s</v></c>' % (ref, val))
                else:
                    parts.append(
                        '<c r="%s" t="s"><v>%d</v></c>' % (ref, sstr(str(val)))
                    )
            parts.append("</row>")
        parts.append("</sheetData>")
        sheet_xmls.append(
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main">%s</worksheet>' % "".join(parts)
        )

    names = list(sheets.keys())
    wb_sheets = "".join(
        '<sheet name="%s" sheetId="%d" r:id="rId%d"/>'
        % (escape(n, {'"': "&quot;"}), i + 1, i + 1)
        for i, n in enumerate(names)
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        "<sheets>%s</sheets></workbook>" % wb_sheets
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            '<Relationship Id="rId%d" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/worksheet" Target="worksheets/sheet%d.xml"/>'
            % (i + 1, i + 1)
            for i in range(len(names))
        )
        + '<Relationship Id="rId%d" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/sharedStrings" Target="sharedStrings.xml"/>'
        % (len(names) + 1)
        + "</Relationships>"
    )
    shared_xml = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<sst xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'count="%d" uniqueCount="%d">%s</sst>'
        % (
            len(shared),
            len(shared),
            "".join("<si><t xml:space=\"preserve\">%s</t></si>" % escape(s) for s in shared),
        )
    )
    overrides = "".join(
        '<Override PartName="/xl/worksheets/sheet%d.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        % (i + 1)
        for i in range(len(names))
    )

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES % overrides)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/sharedStrings.xml", shared_xml)
        for i, xml in enumerate(sheet_xmls):
            z.writestr("xl/worksheets/sheet%d.xml" % (i + 1), xml)


# a cell is either self-closing (<c r=".." s="1"/> — empty, must NOT steal
# the next cell's <v>) or an element whose body may hold <f> (Excel writes
# the formula before the cached <v>) and <v>
_CELL_RE = re.compile(r"<c ([^>]*?)(/>|>(.*?)</c>)", re.S)
_CELL_R_RE = re.compile(r'r="([A-Z]+)(\d+)"')
_CELL_T_RE = re.compile(r't="(\w+)"')
_CELL_V_RE = re.compile(r"<v>([^<]*)</v>")


def _iter_cells(xml):
    """Yield (col_letters, row_digits, type_attr, value_text_or_'') per
    cell, with formula bodies skipped and empty cells yielding ''."""
    for m in _CELL_RE.finditer(xml):
        attrs, closer, body = m.group(1), m.group(2), m.group(3) or ""
        r = _CELL_R_RE.search(attrs)
        if not r:
            continue
        t = _CELL_T_RE.search(attrs)
        v = _CELL_V_RE.search(body) if closer != "/>" else None
        yield r.group(1), r.group(2), t.group(1) if t else "", (
            v.group(1) if v else ""
        )
_SI_RE = re.compile(r"<si>(?:<t[^>]*>)?(.*?)(?:</t>)?</si>", re.S)
_T_RE = re.compile(r"<t[^>]*>(.*?)</t>", re.S)


def _unescape(s: str) -> str:
    return (
        s.replace("&lt;", "<").replace("&gt;", ">").replace("&quot;", '"')
        .replace("&apos;", "'").replace("&amp;", "&")
    )


def read_xlsx(path: str) -> dict:
    """Returns {sheet_name: list of rows (lists; numbers parsed as float)}."""
    with zipfile.ZipFile(path, "r") as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            sst = z.read("xl/sharedStrings.xml").decode("utf-8")
            for si in _SI_RE.findall(sst):
                ts = _T_RE.findall("<t>%s</t>" % si) or [si]
                shared.append(_unescape("".join(ts)))
        wb = z.read("xl/workbook.xml").decode("utf-8")
        # resolve each sheet's worksheet part through the rels (Excel can
        # reorder workbook.xml while keeping the original sheetN.xml
        # targets; positional mapping would join names to the wrong data)
        rel_target = {}
        rels_part = "xl/_rels/workbook.xml.rels"
        if rels_part in z.namelist():
            rels = z.read(rels_part).decode("utf-8")
            for rid, target in re.findall(
                r'<Relationship[^>]*Id="([^"]+)"[^>]*Target="([^"]+)"', rels
            ):
                rel_target[rid] = target.lstrip("/")
        sheets = []
        for tag in re.findall(r"<sheet [^>]*>", wb):  # self-closing OR open tag
            m_name = re.search(r'name="([^"]+)"', tag)
            m_rid = re.search(r'r:id="([^"]+)"', tag)
            if m_name:
                sheets.append((m_name.group(1), m_rid.group(1) if m_rid else None))
        out = {}
        for i, (name, rid) in enumerate(sheets):
            target = rel_target.get(rid, "worksheets/sheet%d.xml" % (i + 1))
            if not target.startswith("xl/"):
                target = "xl/" + target
            xml = z.read(target).decode("utf-8")
            cells = {}
            max_r = max_c = 0
            for col, row, typ, val in _iter_cells(xml):
                r = int(row) - 1
                c = 0
                for ch in col:
                    c = c * 26 + (ord(ch) - ord("A") + 1)
                c -= 1
                if val == "":
                    v = None
                elif typ == "s":
                    v = shared[int(val)]
                elif typ in ("str", "e"):
                    # inline formula-result string / error cell (#DIV/0!):
                    # keep the text rather than crashing float()
                    v = _unescape(val)
                else:
                    v = float(val)
                cells[(r, c)] = v
                max_r, max_c = max(max_r, r), max(max_c, c)
            rows = [
                [cells.get((r, c)) for c in range(max_c + 1)]
                for r in range(max_r + 1)
            ]
            out[_unescape(name)] = rows
    return out
