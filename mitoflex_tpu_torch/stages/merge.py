"""Contig overlap merging.

Port of mitoflex_tpu/stages/merge.py, whose merge algebra is host code:
it is copied here because the reference module imports the jax-importing
blast module. The homology search is the port's ``models.blast.blastn`` on
the caller's ``device``.

- ``merge_feasible``: merge iff one sequence contains the other, or the
  concatenation is strictly longer than both and within max_length;
- ``wash_merge_frame``: terminal-overlap filter within search_range,
  que/subj pair dedup;
- ``merge_overlaps``: greedy pairwise merging with revcomp handling,
  emitting ``M{i}`` records with the ``multi=32767`` sentinel;
- ``merge_sequences`` / ``merge_partial``: the fixpoint loops.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import pandas as pd

from mitoflex_tpu.io import encoding
from mitoflex_tpu.io.fasta import FastaRecord
from mitoflex_tpu.utils.logger import logger
from mitoflex_tpu.utils.seq import MERGED_MULTI_SENTINEL

from ..models import blast


def merge_feasible(
    que: int, sub: int, alen: int, qs: int, qe: int, ss: int, se: int, max_length: int
) -> bool:
    """merge_calculation_internal (lib.rs:14-45). Coordinates 1-based as in
    outfmt 6."""
    qs = qs - 1
    ss = ss - 1
    if alen >= que or alen >= sub:
        return True
    if ss > se:
        ss, se = sub - se, sub - ss
    length = sub + (qe - se if qs > ss else se - qe)
    if length > max_length:
        return False
    return length > sub and length > que


def wash_merge_frame(
    frame: pd.DataFrame,
    seq_lens: Dict[str, int],
    search_range: int,
    overlapped_len: int,
    max_length: int,
) -> pd.DataFrame:
    """wash_merge_blast (lib.rs:62-133) on an in-memory frame."""
    keep = []
    seen = set()
    for idx, r in frame.iterrows():
        if r.qseq == r.sseq:
            continue
        if r.length < overlapped_len:
            continue
        if (r.sseq + r.qseq) in seen:
            continue
        seen.add(r.qseq + r.sseq)
        que = seq_lens.get(r.qseq, 0)
        sub = seq_lens.get(r.sseq, 0)
        if not que or not sub:
            continue
        ss, se = int(r.sstart), int(r.send)
        qs, qe = int(r.qstart), int(r.qend)
        if r.length < que and r.length < sub and search_range >= 0:
            if (ss > search_range and sub - se > search_range) or (
                qs > search_range and que - qe > search_range
            ):
                continue
        if not merge_feasible(que, sub, int(r.length), qs, qe, ss, se, max_length):
            continue
        keep.append(idx)
    return frame.loc[keep]


def _merge_pair(
    sque: FastaRecord, ssub: FastaRecord, alen: int,
    qs: int, qe: int, ss: int, se: int, new_id: str,
) -> FastaRecord:
    """One pairwise merge (merge_overlaps inner logic, lib.rs:160-213).
    Coordinates 1-based; ss>se means the subject aligns reverse."""
    qs, qe = qs - 1, qe
    sub_seq = ssub.seq
    if ss > se:
        L = len(sub_seq)
        ss, se = L - ss, L - (se - 1)
        ss, se = min(ss, se), max(ss, se)
        sub_seq = encoding.revcomp_str(sub_seq)
    else:
        ss, se = ss - 1, se
    if alen >= len(sque.seq):
        return ssub
    if alen >= len(sub_seq):
        return sque
    if qs > ss:
        new_seq = sque.seq[:qe] + sub_seq[se:]
    else:
        new_seq = sub_seq[:se] + sque.seq[qe:]
    return FastaRecord(
        new_id, new_seq,
        {"flag": 1, "multi": MERGED_MULTI_SENTINEL, "len": len(new_seq)},
    )


def merge_overlaps(
    frame: pd.DataFrame, seqs: Dict[str, FastaRecord], start_index: int
) -> Tuple[List[FastaRecord], int]:
    """Greedy merge over a washed blast frame, highest priority last-row
    first (the reference sorts by score then pops from the end)."""
    records: List[FastaRecord] = []
    consumed = set()
    idx = start_index
    rows = list(frame.itertuples())
    while rows:
        r = rows.pop()
        if r.qseq in consumed or r.sseq in consumed:
            continue
        merged = _merge_pair(
            seqs[r.qseq], seqs[r.sseq], int(r.length),
            int(r.qstart), int(r.qend), int(r.sstart), int(r.send), f"M{idx}",
        )
        records.append(merged)
        consumed.update((r.qseq, r.sseq))
        idx += 1
        rows = [x for x in rows if x.qseq not in consumed and x.sseq not in consumed]
    leftovers = [v for k, v in seqs.items() if k not in consumed]
    return records + leftovers, idx


def merge_sequences(
    records: List[FastaRecord],
    overlapped_len: int = 50,
    search_range: int = 5,
    max_length: int = 20000,
    index: int = 0,
    device=None,
) -> Tuple[List[FastaRecord], int]:
    """Global self-vs-self merge fixpoint (findmitoscaf.py:471-506)."""
    if len(records) <= 1:
        return records, index
    for _ in range(16):  # fixpoint cap: each round must merge >=1 pair
        seqs = {r.id: r for r in records}
        frame = blast.blastn(records, records, skip_self=True, device=device)
        if frame.empty:
            break
        washed = wash_merge_frame(
            frame, {r.id: len(r.seq) for r in records},
            search_range, overlapped_len, max_length,
        )
        if washed.empty:
            break
        washed = washed.sort_values(["score", "ident"], kind="stable")
        records, new_index = merge_overlaps(washed, seqs, index)
        if new_index == index:
            break
        logger.debug(f"merge_sequences: merged {new_index - index} pairs")
        index = new_index
    return records, index


def merge_partial(
    picked: List[FastaRecord],
    db_records: List[FastaRecord],
    overlapped_len: int = 50,
    search_range: int = 5,
    max_length: int = 20000,
    device=None,
) -> Tuple[List[FastaRecord], List[FastaRecord], int]:
    """Partial merge: picked set against itself, then against the wider
    contig set (findmitoscaf.py merge_partial:510-590). Returns (picked',
    db', merges)."""
    index = 0
    for _ in range(16):  # fixpoint cap
        picked, index_merged = merge_sequences(
            picked, overlapped_len, search_range, max_length, index, device
        )
        modified = index_merged > index
        index = index_merged

        frame = blast.blastn(picked, db_records, skip_self=True, device=device)
        if not frame.empty:
            frame = frame[frame.qseq != frame.sseq]
            frame = frame[
                ((frame.sstart < search_range) & (frame.send < search_range))
                | (frame.qstart < search_range)
            ]
            frame = frame[frame.length >= overlapped_len]
        if frame.empty:
            if not modified:
                break
            continue
        all_seqs = {r.id: r for r in picked + db_records}
        ok = frame.apply(
            lambda r: merge_feasible(
                len(all_seqs[r.qseq].seq), len(all_seqs[r.sseq].seq),
                int(r.length), int(r.qstart), int(r.qend),
                int(r.sstart), int(r.send), max_length,
            ),
            axis=1,
        )
        frame = frame[ok]
        if frame.empty:
            if not modified:
                break
            continue
        frame = frame.sort_values("score", ascending=True, kind="stable")
        merged_rows, index2 = merge_overlaps(
            frame, {k: all_seqs[k] for k in set(frame.qseq) | set(frame.sseq)}, index
        )
        new_merged = [r for r in merged_rows if r.id.startswith("M")]
        consumed = (set(frame.qseq) | set(frame.sseq)) - {r.id for r in merged_rows}
        if index2 == index:
            break
        modified = True
        index = index2
        picked = [r for r in picked if r.id not in consumed] + [
            r for r in new_merged if r.id not in {p.id for p in picked}
        ]
        db_records = [r for r in db_records if r.id not in consumed]
    return picked, db_records, index
