"""locs.json against the planted genes: genes (PCGs, tRNAs, rRNAs; the one
that the linearised circle's ends may cut left out) that are missing, on
the wrong strand, of the wrong kind, or whose annotated fragment is not a
stretch of the planted gene (the configuration's end tolerance of slack)
covering more than half of it; the most over the window's samples. The
limit is the configuration's. How far a found gene's ends lie from the
planted ones is ``gene_end_gap_nt``'s to hold."""

from __future__ import annotations

import sys

from ..reference import outputs, truth

LIMIT = 0


def compare(cell) -> float:
    worst = 0
    tol = int(cell.config["annotate_end_tolerance_nt"])
    for s in cell.done:
        if s.outputs is None:
            continue
        frags = outputs.fragments(s.outputs)
        scaffold = "".join(seq for _, seq in outputs.picked(s.outputs))
        missed, cut, end = truth.genes_missed(cell.mito.genes, cell.mito.genome,
                                              outputs.locs(s.outputs), frags, scaffold, tol)
        if len(cut) > 1:
            missed += cut[1:]
        print(f"genes_missed sample {s.index}: missed {missed}, cut by the circle's ends "
              f"{cut}, largest end difference of a found gene {end} nt", file=sys.stderr)
        worst = max(worst, len(missed))
    return worst
