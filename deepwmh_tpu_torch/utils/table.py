"""ASCII table rendering (the port's copy of ``deepwmh_tpu.utils.table``)."""

from __future__ import annotations


def render_table(headers, rows, max_col_width: int = 40) -> str:
    """A boxed table of ``headers`` and ``rows`` (any values, shown with
    ``str``); a cell wider than ``max_col_width`` is cut with an ellipsis."""
    headers = [str(h) for h in headers]
    rows = [[str(c) for c in row] for row in rows]
    widths = [len(h) for h in headers]
    for row in rows:
        for i, c in enumerate(row):
            widths[i] = min(max(widths[i], len(c)), max_col_width)

    def clip(s, w):
        return s if len(s) <= w else s[: w - 1] + "…"

    def line(cells):
        return "| " + " | ".join(clip(c, w).ljust(w) for c, w in zip(cells, widths)) + " |"

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    return "\n".join([sep, line(headers), sep] + [line(row) for row in rows] + [sep])


def print_table(headers, rows, **kw):
    print(render_table(headers, rows, **kw))
