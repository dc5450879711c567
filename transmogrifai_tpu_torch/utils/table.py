"""ASCII table formatting for summaries (reference
utils/.../table/Table.scala — the renderer behind the README model
summary tables and summaryPretty output)."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence


def format_table(columns: Sequence[str], rows: Sequence[Sequence[Any]],
                 title: Optional[str] = None,
                 max_col_width: int = 45) -> str:
    """Render rows as a boxed ASCII table.

    Cells stringify (floats to 6 significant digits) and truncate to
    `max_col_width` with an ellipsis; numeric cells right-align, text
    left-aligns — matching the reference Table's formatting rules.
    """
    def cell(v: Any) -> str:
        if isinstance(v, float):
            s = f"{v:.6g}"
        else:
            s = str(v)
        if len(s) > max_col_width:
            s = s[: max_col_width - 1] + "…"
        return s

    def is_num(v: Any) -> bool:
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    headers = [cell(c) for c in columns]
    body = [[cell(v) for v in r] for r in rows]
    n_cols = len(headers)
    widths = [len(h) for h in headers]
    for r in body:
        for j in range(min(len(r), n_cols)):
            widths[j] = max(widths[j], len(r[j]))
    right = [all(is_num(r[j]) for r in rows if j < len(r) and r[j] is not None)
             and any(j < len(r) for r in rows)
             for j in range(n_cols)]

    def fmt_row(cells: List[str]) -> str:
        out = []
        for j in range(n_cols):
            s = cells[j] if j < len(cells) else ""
            out.append(s.rjust(widths[j]) if right[j] else s.ljust(widths[j]))
        return "| " + " | ".join(out) + " |"

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = []
    if title:
        total = len(sep)
        t = title if len(title) <= total - 4 \
            else title[: max(total - 5, 0)] + "…"
        lines.append("+" + "-" * (total - 2) + "+")
        lines.append("| " + t.ljust(total - 4) + " |")
    lines.append(sep)
    lines.append(fmt_row(headers))
    lines.append(sep)
    for r in body:
        lines.append(fmt_row(r))
    lines.append(sep)
    return "\n".join(lines)
