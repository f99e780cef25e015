"""Terminal-overlap detection (circularity) and longest-common-substring DP.

Replaces the reference's Rust ``seq_overlap`` (misc/fastmathcal/src/lib.rs:
232-260: O(n*m) longest exact common substring with start coordinates; the
Rust version leans on wrapping-underflow `.get()` misses for the border —
here the DP border is explicit) and ``check_circular``
(misc/check_circular.py:40-55).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..io.fasta import FastaRecord


def seq_overlap(seq1: str, seq2: str) -> Tuple[int, int, int]:
    """Longest exact common substring of seq1 and seq2.

    Returns (start1, start2, length), 0-based starts; (0, 0, 0) when there
    is no common character."""
    a = np.frombuffer(seq1.encode(), dtype=np.uint8)
    b = np.frombuffer(seq2.encode(), dtype=np.uint8)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return (0, 0, 0)
    prev = np.zeros(m, dtype=np.int32)
    best_v, best_i, best_j = 0, 0, 0
    for i in range(n):
        eq = (b == a[i]).astype(np.int32)
        cur = eq.copy()
        cur[1:] += prev[:-1] * eq[1:]
        prev = cur
        j = int(cur.argmax())
        v = int(cur[j])
        if v > best_v:
            best_v, best_i, best_j = v, i, j
    if best_v == 0:
        return (0, 0, 0)
    return (best_i + 1 - best_v, best_j + 1 - best_v, best_v)


def check_circular(
    final_seqs: Iterable[FastaRecord],
    minimum_length: int = 10000,
    start_length: int = 500,
    end_length: int = 500,
    overlaps: int = 50,
) -> Iterator[Tuple[Optional[Tuple[int, int, int]], FastaRecord]]:
    """Yield ((f_start, f_end, overlap_len) | None, record) per sequence —
    the reference's generator contract (misc/check_circular.py:40-55):
    sequences shorter than minimum_length are skipped; otherwise the first
    start_length bases are matched against the last end_length bases and
    an overlap >= ``overlaps`` marks the sequence circular."""
    for record in final_seqs:
        seq = record.seq
        if len(seq) < minimum_length:
            yield (None, record)
            continue
        f = seq[:start_length]
        r = seq[-end_length:]
        f_start, f_end, ali_length = seq_overlap(f, r)
        if ali_length < overlaps:
            yield (None, record)
        else:
            yield ((f_start, f_end, ali_length), record)


def trim_circular(record: FastaRecord, **kwargs) -> Tuple[FastaRecord, bool]:
    """If the sequence's head repeats at its tail (circular assembly
    artifact), cut the duplicated tail — the annotate stage's fix_circular
    behavior (annotation/annotation.py:261-273)."""
    for info, rec in check_circular([record], **kwargs):
        if info is None:
            return rec, False
        f_start, f_end, length = info
        end_length = kwargs.get("end_length", 500)
        # overlap located at tail offset f_end within the last end_length bp
        cut = len(rec.seq) - end_length + f_end
        trimmed = rec.seq[:cut]
        attrs = dict(rec.attrs)
        attrs["flag"] = int(attrs.get("flag", 0) or 0) | 1
        attrs["len"] = len(trimmed)
        return FastaRecord(rec.id, trimmed, attrs), True
    return record, False
