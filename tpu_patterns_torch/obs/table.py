"""Fixed-width markdown tables for the ``obs`` readers.

The JAX package renders its ``obs summarize``, ``obs explain`` and
``obs cost`` tables with ``tabulate`` (``tablefmt="github"``), which the
machine with the card does not have; this is the port's own renderer of
the same rows: a header row, a ``|---|`` rule and one row a line, each
cell padded to its column's width, numbers right-aligned.
"""

from __future__ import annotations


def _is_number(v) -> bool:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return True
    try:
        float(str(v))
    except ValueError:
        return False
    return str(v) != ""


def markdown_table(rows: list[list], headers: list[str]) -> str:
    """``rows`` under ``headers`` as a github-style markdown table."""
    cells = [[str(c) for c in r] for r in rows]
    widths = [len(h) for h in headers]
    for r in cells:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    right = [
        bool(rows) and all(_is_number(r[i]) or str(r[i]) == "" for r in rows)
        for i in range(len(headers))
    ]

    def line(vals: list[str]) -> str:
        return "| " + " | ".join(
            v.rjust(w) if r else v.ljust(w)
            for v, w, r in zip(vals, widths, right)
        ) + " |"

    rule = "|" + "|".join(
        "-" * (w + 1) + ":" if r else "-" * (w + 2)
        for w, r in zip(widths, right)
    ) + "|"
    return "\n".join([line(list(headers)), rule] + [line(r) for r in cells])
