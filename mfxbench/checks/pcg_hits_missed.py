"""nhmmer's hit frame against the planted PCGs: PCGs without a hit on the
picked circle, on their strand, whose span is the planted one within the
configuration's end tolerance (genes cut by the circle's ends left out);
the most over the window's samples. The limit is the configuration's."""

from __future__ import annotations

from ..reference import outputs, truth
from .circle_diff_bases import best_place

LIMIT = 0


def compare(cell) -> float:
    worst = 0
    tol = int(cell.config["annotate_end_tolerance_nt"])
    for s in cell.done:
        if s.outputs is None:
            continue
        b = best_place(cell, outputs.picked(s.outputs))
        if b is None:
            return len(cell.mito.pcg_nt)
        name, seq, place = b
        missed, _ = truth.hits_missed(cell.mito.genes, cell.mito.genome,
                                      outputs.frame_rows(s.outputs), name, place, len(seq), tol)
        worst = max(worst, len(missed))
    return worst
