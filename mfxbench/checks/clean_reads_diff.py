"""The filter's clean reads against the reference filter on the same reads:
records that differ (kept where they should be dropped or the reverse, or
written changed), summed over the window's samples. Exact."""

from __future__ import annotations

import numpy as np

from ..reference import filter_rule

LIMIT = 0


def _records(path: str) -> dict:
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return {lines[i]: (lines[i + 1], lines[i + 3]) for i in range(0, len(lines) - 3, 4)}


def compare(cell) -> float:
    rule = cell.config["pipeline"]["filter"]
    total = 0
    for s in cell.done:
        if s.outputs is None:
            continue
        t = s.truth
        keep = filter_rule.keep_pairs(t.r1, t.q1, t.r2, t.q2, rule["ns_valve"],
                                      rule["quality_valve"], rule["percentage_valve"])
        rows = np.nonzero(keep)[0]
        names = [t.names[i] for i in rows]
        for path, reads, quals in zip(s.outputs["clean"], (t.r1, t.r2), (t.q1, t.q2)):
            want = filter_rule.fastq_bytes(names, reads[rows], quals[rows])
            with open(path, "rb") as f:
                if f.read() == want:
                    continue
            got = _records(path)
            exp = {n.encode(): (filter_rule.LUT[r].tobytes(), q.tobytes())
                   for n, r, q in zip(names, reads[rows], quals[rows])}
            total += len(set(got) ^ set(exp)) + sum(got[n] != exp[n] for n in set(got) & set(exp))
    return total
