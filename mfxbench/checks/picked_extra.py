"""Records picked besides the planted circle (nuclear contigs taken for
mitochondrial ones, or the circle in pieces), the most over the window's
samples. Exact."""

from __future__ import annotations

from ..reference import outputs
from .circle_diff_bases import best_place

LIMIT = 0


def compare(cell) -> float:
    worst = 0
    for s in cell.done:
        if s.outputs is None:
            continue
        records = outputs.picked(s.outputs)
        worst = max(worst, len(records) - (best_place(cell, records) is not None))
    return worst
