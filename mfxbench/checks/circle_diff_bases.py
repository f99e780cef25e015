"""The picked set's circle against the planted mitogenome: bases that
differ once the best picked record is placed on the genome (up to rotation,
strand and a terminal duplication), the genome's length where none can be
placed; the largest over the window's samples. Exact."""

from __future__ import annotations

from ..reference import outputs, truth

LIMIT = 0


def best_place(cell, records):
    """(record id, its sequence, placement) of the record that is the
    planted circle with the fewest mismatches, or None."""
    best = None
    for name, seq in records:
        p = truth.place_circle(seq, cell.mito.genome)
        if p is not None and (best is None or p[2] < best[2][2]):
            best = (name, seq, p)
    return best


def compare(cell) -> float:
    worst = 0
    for s in cell.done:
        if s.outputs is None:
            continue
        b = best_place(cell, outputs.picked(s.outputs))
        worst = max(worst, len(cell.mito.genome) if b is None else b[2][2])
    return worst
