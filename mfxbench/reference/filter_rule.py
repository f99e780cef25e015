"""MitoFlex's read filter, as the configuration states it, on the reads the
generator made: a pair is kept iff each mate has at most ``ns_valve`` Ns
and fewer than floor(f32(len of mate 1) * f32(percentage_valve)) bases
whose quality byte is at most ``quality_valve``; kept pairs are written
unchanged, in input order."""

from __future__ import annotations

import numpy as np

LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def keep_pairs(r1, q1, r2, q2, ns_valve: int, quality_valve: int,
               percentage_valve: float) -> np.ndarray:
    cutoff = np.floor(np.float32(r1.shape[1]) * np.float32(percentage_valve))

    def mate_ok(r, q):
        return ((r == 4).sum(1) <= ns_valve) & ((q <= quality_valve).sum(1) < cutoff)

    return mate_ok(r1, q1) & mate_ok(r2, q2)


def fastq_bytes(names, reads: np.ndarray, quals: np.ndarray) -> bytes:
    """Records ``name\\nseq\\n+\\nqual\\n``."""
    return b"".join(b"%s\n%s\n+\n%s\n" % (n.encode(), LUT[r].tobytes(), q.tobytes())
                    for n, r, q in zip(names, reads, quals))
