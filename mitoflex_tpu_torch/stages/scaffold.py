"""Mate-pair scaffolding.

Port of mitoflex_tpu/stages/scaffold.py onto the port's mapper (the rest
of the module is jax-free and unchanged in behaviour). It replaces the
reference's vendored SOAPdenovo2 path (assemble/
scaffold_wrapper.py:17-91 driving SOAPdenovo-fusion / 127mer map / scaff,
then scaf2mega): paired-end reads whose mates land on different contigs
link those contigs into scaffolds.

1. both mates of every pair are placed with the seed-vote mapper
   (ops/mapper.py) — the SOAP `map` step;
2. cross-contig pairs vote on (contig A end, contig B end, gap): a proper
   FR pair at insert size ~I implies orientation and an estimated gap —
   the `fusion` graph;
3. links with >= ``pair_num_cutoff`` (3, scaffold_wrapper soaplib
   contract) supporting pairs and a consistent majority orientation are
   kept; contigs are chained greedily by link weight into linear
   scaffolds — the `scaff` step;
4. joined sequences first try a direct terminal overlap (ops/overlap),
   else insert the estimated run of Ns; emitted with megahit-style
   headers and the ``multi=32767`` sentinel + circularity re-check, like
   scaf2mega (scaffold_wrapper.py:80-91).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mitoflex_tpu.config import AssembleConfig
from mitoflex_tpu.io import encoding, fastq
from mitoflex_tpu.io.fasta import FastaRecord, load_fasta, write_fasta
from mitoflex_tpu.ops.overlap import check_circular, seq_overlap
from mitoflex_tpu.utils.helper import timed
from mitoflex_tpu.utils.logger import logger
from mitoflex_tpu.utils.seq import MERGED_MULTI_SENTINEL

from ..ops import mapper

PAIR_NUM_CUTOFF = 3   # soaplib pair_num_cutoff (scaffold_wrapper.py:36-49)


@dataclass
class _Link:
    gaps: List[int]
    count: int = 0


def _orient_key(c1: int, end1: int, c2: int, end2: int) -> Tuple:
    """Normalize a link so (smaller contig id first)."""
    if (c2, end2) < (c1, end1):
        return (c2, end2, c1, end1)
    return (c1, end1, c2, end2)


@timed()
def scaffold_contigs(
    cfg: AssembleConfig,
    contigs_path: str,
    clean1: str,
    clean2: str,
    out_path: str,
    max_read_len: int = 256,
    max_pairs: int = 500_000,
    device=None,
) -> str:
    records = load_fasta(contigs_path)
    if len(records) <= 1:
        write_fasta(records, out_path)
        return out_path
    index = mapper.ContigIndex.build(records, device)
    lengths = [len(r.seq) for r in records]
    insert = cfg.insert_size

    links: Dict[Tuple, _Link] = defaultdict(lambda: _Link([]))
    seen_pairs = 0
    for b1, b2 in fastq.read_pair_batches(clean1, clean2, 8192, max_read_len):
        m1 = mapper.map_batch(index, b1.seqs[: b1.count], b1.lengths[: b1.count])
        m2 = mapper.map_batch(index, b2.seqs[: b2.count], b2.lengths[: b2.count])
        for i in range(b1.count):
            c1, c2 = int(m1.contig[i]), int(m2.contig[i])
            if c1 < 0 or c2 < 0 or c1 == c2:
                continue
            # orientation: mate pointing toward a contig end links that end.
            # strand +1 read at pos p extends rightward: links RIGHT end
            # (end=1) if close to it; strand -1 links LEFT end (end=0).
            def end_and_dist(m, idx, clen, rlen):
                if m.strand[idx] == 1:
                    return 1, clen - int(m.pos[idx])
                return 0, int(m.pos[idx]) + rlen

            e1, d1 = end_and_dist(m1, i, lengths[c1], int(b1.lengths[i]))
            e2, d2 = end_and_dist(m2, i, lengths[c2], int(b2.lengths[i]))
            gap = insert - d1 - d2
            if gap < -insert or gap > 3 * insert:
                continue
            key = _orient_key(c1, e1, c2, e2)
            link = links[key]
            link.count += 1
            link.gaps.append(gap)
        seen_pairs += b1.count
        if seen_pairs >= max_pairs:
            break

    good = {
        k: v for k, v in links.items() if v.count >= PAIR_NUM_CUTOFF
    }
    logger.info(f"scaffold: {len(good)} contig links with >= {PAIR_NUM_CUTOFF} pairs")

    # greedy chaining: strongest links first; each contig end used once
    used_ends: set = set()
    joins: List[Tuple[int, int, int, int, int]] = []  # c1,e1,c2,e2,gap
    for key, link in sorted(good.items(), key=lambda kv: -kv[1].count):
        c1, e1, c2, e2 = key
        if (c1, e1) in used_ends or (c2, e2) in used_ends:
            continue
        used_ends.add((c1, e1))
        used_ends.add((c2, e2))
        joins.append((c1, e1, c2, e2, int(np.median(link.gaps))))

    # assemble chains
    adj: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
    for c1, e1, c2, e2, gap in joins:
        adj[(c1, e1)] = (c2, e2, gap)
        adj[(c2, e2)] = (c1, e1, gap)

    def oriented_seq(ci: int, enter_end: int) -> str:
        """Sequence of contig ci read so that we ENTER at enter_end and
        exit at the other end."""
        s = records[ci].seq
        return s if enter_end == 0 else encoding.revcomp_str(s)

    # Each contig end is used by at most one join (greedy matching above),
    # so the link graph decomposes into simple PATHS and RINGS — nothing
    # else. Chains start at every unlinked end (walking from one end of a
    # path consumes it whole, so its far-end start is skipped as visited);
    # any contig left after that is on a ring, which is broken at its
    # lowest-id contig (the closing link's gap is dropped — a circular
    # scaffold is emitted linearized, flagged by the circularity re-check
    # below like scaf2mega).
    visited = set()
    starts: List[Tuple[int, int]] = []
    for ci in range(len(records)):
        linked0, linked1 = (ci, 0) in adj, (ci, 1) in adj
        if not linked0:
            starts.append((ci, 0))      # isolated contigs land here too
        elif not linked1:
            starts.append((ci, 1))
    starts += [(ci, 0) for ci in range(len(records))]  # ring fallback

    def walk(ci: int, enter: int) -> List:
        """Forward walk: [(contig, entry_end), ("gap", n), ...]."""
        visited.add(ci)
        chain: List = [(ci, enter)]
        while True:
            nxt = adj.get((chain[-1][0], 1 - chain[-1][1]))
            if nxt is None or nxt[0] in visited:
                return chain
            ncur, nent, gap = nxt
            visited.add(ncur)
            chain.append(("gap", gap))
            chain.append((ncur, nent))

    out_records: List[FastaRecord] = []
    sidx = 0
    for ci, enter in starts:
        if ci in visited:
            continue
        chain = walk(ci, enter)
        # render
        parts: List[str] = []
        pending_gap: Optional[int] = None
        for item in chain:
            if item[0] == "gap":
                pending_gap = max(int(item[1]), 0)
                continue
            ci2, ent = item
            seg = oriented_seq(ci2, ent)
            if parts and pending_gap is not None:
                tail = parts[-1][-200:]
                head = seg[:200]
                s1, s2, ln = seq_overlap(tail, head)
                if ln >= 20 and s1 + ln >= len(tail) - 2 and s2 <= 2:
                    # direct overlap join
                    parts[-1] = parts[-1][: len(parts[-1]) - len(tail) + s1]
                    parts.append(head[s2:] + seg[200:])
                else:
                    parts.append("N" * max(pending_gap, 1) + seg)
            else:
                parts.append(seg)
            pending_gap = None
        seq = "".join(parts)
        n_contigs = sum(1 for it in chain if it[0] != "gap")
        if n_contigs > 1:
            rec = FastaRecord(
                f"scaffold_{sidx}", seq,
                {"flag": 1, "multi": MERGED_MULTI_SENTINEL, "len": len(seq)},
            )
        else:
            rec = records[chain[0][0]]
        sidx += 1
        out_records.append(rec)

    # circularity flag like scaf2mega (scaffold_wrapper.py:80-91)
    final = []
    for rec in out_records:
        info = next(iter(check_circular([rec])))[0] if len(rec.seq) >= 10000 else None
        if info is not None:
            rec = rec.with_attrs(flag=rec.flag | 1)
        final.append(rec)
    write_fasta(final, out_path)
    logger.info(
        f"scaffold: {len(records)} contigs -> {len(final)} scaffolds"
    )
    return out_path
