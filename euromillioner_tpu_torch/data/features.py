"""Date feature engineering (reference Main.java:91-98).

Column 0 of each draw row is a date formatted ``"E, MMM d, yyyy"`` (e.g.
``"Tue, Jun 9, 2020"``); it becomes 4 integer features — day_of_week
(Monday=1 … Sunday=7, java.time semantics), month (1-12), day, year.
Remaining columns (five main balls + two special balls) pass through as
numbers, giving the 11-column schema of Main.java:69.
"""

from __future__ import annotations

from datetime import datetime

from euromillioner_tpu_torch.utils.errors import ParseError

# Java "E, MMM d, yyyy" (Main.java:92) → strptime equivalent.
_DATE_FORMAT = "%a, %b %d, %Y"


def date_features(text: str, date_format: str = _DATE_FORMAT) -> tuple[int, int, int, int]:
    """Parse a draw date into (day_of_week, month, day, year).

    day_of_week uses java.time ``getDayOfWeek().getValue()`` numbering:
    Monday=1 … Sunday=7 (Main.java:94).
    """
    try:
        d = datetime.strptime(text.strip(), date_format).date()
    except ValueError as e:
        raise ParseError(f"unparseable draw date {text!r}: {e}") from e
    return (d.isoweekday(), d.month, d.day, d.year)


def row_to_features(
    cells: list[str], date_format: str = _DATE_FORMAT
) -> list[float]:
    """One table row → 11 numeric features (4 date + 7 balls).

    Mirrors the reference row loop (Main.java:86-105): cell 0 is expanded to
    the four date features, every other cell is emitted as-is.
    """
    if not cells:
        raise ParseError("empty draw row")
    out: list[float] = [float(v) for v in date_features(cells[0], date_format)]
    for j, text in enumerate(cells[1:], start=1):
        try:
            out.append(float(text))
        except ValueError as e:
            raise ParseError(f"non-numeric cell {j} ({text!r}) in draw row") from e
    return out
