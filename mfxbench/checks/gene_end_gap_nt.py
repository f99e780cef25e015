"""locs.json against the planted genes: the largest distance, in bases,
between an end of a found gene's annotated fragment and the same end of
the planted gene (``genes_missed`` counts the genes not found), the most
over the window's samples. A tblastn (S1), genewise (G1) or rRNA CYK (C1)
answer that ends an alignment early or late shows here."""

from __future__ import annotations

from ..reference import outputs, truth

LIMIT = 54


def compare(cell) -> float:
    worst = 0
    tol = int(cell.config["annotate_end_tolerance_nt"])
    for s in cell.done:
        if s.outputs is None:
            continue
        _, _, end = truth.genes_missed(cell.mito.genes, cell.mito.genome,
                                       outputs.locs(s.outputs), outputs.fragments(s.outputs),
                                       "".join(seq for _, seq in outputs.picked(s.outputs)), tol)
        worst = max(worst, end)
    return worst
