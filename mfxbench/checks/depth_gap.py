"""The depth track against the depth that the reference filter's kept
mitochondrial pairs give: |mean depth over the circle's rows / (kept
mitochondrial read bases / genome length) - 1|, the largest over the
window's samples."""

from __future__ import annotations

import numpy as np

from ..reference import filter_rule, outputs
from .circle_diff_bases import best_place

LIMIT = 0.05


def compare(cell) -> float:
    rule = cell.config["pipeline"]["filter"]
    worst = 0.0
    G = len(cell.mito.genome)
    for s in cell.done:
        if s.outputs is None:
            continue
        t = s.truth
        keep = filter_rule.keep_pairs(t.r1, t.q1, t.r2, t.q2, rule["ns_valve"],
                                      rule["quality_valve"], rule["percentage_valve"])
        want = 2 * t.r1.shape[1] * int((keep & (t.source == 0)).sum()) / G
        records = outputs.picked(s.outputs)
        b = best_place(cell, records)
        if b is None:
            return 1.0
        rows = outputs.depth_rows(s.outputs["depth"])
        # the depth track renames the picked records mt1, mt2, ... in order
        contig = f"mt{[n for n, _ in records].index(b[0]) + 1}"
        got = float(np.mean(rows.get(contig, [0])))
        worst = max(worst, abs(got / want - 1.0))
    return worst
