"""HTML results-table extraction (stdlib, no Jsoup).

Reference semantics (Main.java:60-67): Jsoup-parse the body, select the
first element with the exact Bootstrap class string
``"table table-bordered table-condensed table-striped text-center table-hover"``,
take ``child(0)`` (the table's first section, e.g. its tbody), list its row
children, and drop row 0 (the "info row"). This module reproduces that with
``html.parser``: rows are taken from the *first section* of the *first
matching table* only; the caller drops the info row.
"""

from __future__ import annotations

from html.parser import HTMLParser

from euromillioner_tpu_torch.utils.errors import ParseError

_SECTION_TAGS = {"thead", "tbody", "tfoot"}


class _TableExtractor(HTMLParser):
    """Collects rows (lists of cell texts) from the first table whose class
    attribute contains all requested classes, first section only."""

    def __init__(self, wanted_classes: set[str]):
        super().__init__(convert_charrefs=True)
        self.wanted = wanted_classes
        self.rows: list[list[str]] = []
        self.found_table = False
        self._in_target = False
        self._table_depth = 0
        self._section_idx = -1   # increments per thead/tbody/tfoot in target table
        self._implicit_section = False  # <tr> directly under <table>
        self._in_row = False
        self._in_cell = False
        self._cell_parts: list[str] = []
        self._row: list[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "table":
            if self._in_target:
                self._table_depth += 1  # nested table: ignore its rows
                return
            if not self.found_table:
                cls = dict(attrs).get("class", "") or ""
                if self.wanted.issubset(set(cls.split())):
                    self.found_table = True
                    self._in_target = True
                    self._table_depth = 0
                    self._section_idx = -1
            return
        if not self._in_target or self._table_depth > 0:
            return
        if tag in _SECTION_TAGS:
            self._section_idx += 1
        elif tag == "tr":
            if self._section_idx < 0 and not self._implicit_section:
                # rows directly under <table> form the implicit first section
                self._implicit_section = True
                self._section_idx = 0
            if self._section_idx == 0:
                self._in_row = True
                self._row = []
        elif tag in ("td", "th") and self._in_row:
            self._in_cell = True
            self._cell_parts = []

    def handle_endtag(self, tag):
        if tag == "table" and self._in_target:
            if self._table_depth > 0:
                self._table_depth -= 1
            else:
                self._in_target = False
            return
        if not self._in_target or self._table_depth > 0:
            return
        if tag in ("td", "th") and self._in_cell:
            self._in_cell = False
            # Jsoup Element.text(): whitespace-normalized
            self._row.append(" ".join("".join(self._cell_parts).split()))
        elif tag == "tr" and self._in_row:
            self._in_row = False
            self.rows.append(self._row)

    def handle_data(self, data):
        if self._in_cell:
            self._cell_parts.append(data)


def extract_table_rows(
    html: str,
    table_class: str,
    *,
    drop_info_row: bool = True,
) -> list[list[str]]:
    """Extract row texts from the first matching table's first section.

    ``drop_info_row=True`` removes row 0, as the reference does
    (``elements.remove(0)``, Main.java:67).
    """
    parser = _TableExtractor(set(table_class.split()))
    parser.feed(html)
    parser.close()
    if not parser.found_table:
        raise ParseError(
            f"no table with class {table_class!r} found in document")
    rows = parser.rows
    if drop_info_row:
        if not rows:
            raise ParseError("results table has no rows (expected info row + data)")
        rows = rows[1:]
    return rows
