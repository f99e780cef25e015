"""Comparisons of the pipeline's files with what the generators planted.

The picked circle against the planted genome (up to rotation, strand and
a terminal duplication), the annotated genes against the planted ones (a
gene is found where its fragment lies inside the planted span and covers
most of it: with diverged homologs in the protein database, genewise's
ends may fall a few codons inside the planted ones), the
profile-search hits against the planted PCGs, and the depth track against
the depth that the kept reads give.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def read_fasta(path: str) -> List[Tuple[str, Dict[str, str], str]]:
    """(id, key=value attributes, sequence) of each record."""
    out = []
    name, attrs, chunks = None, {}, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, attrs, "".join(chunks)))
                toks = line[1:].split()
                name = toks[0] if toks else ""
                attrs = dict(t.split("=", 1) for t in toks[1:] if "=" in t)
                chunks = []
            elif line:
                chunks.append(line.strip())
    if name is not None:
        out.append((name, attrs, "".join(chunks)))
    return out


def place_circle(seq: str, genome: str) -> Optional[Tuple[int, int, int]]:
    """(offset, orientation, mismatches) that place ``seq`` on the circular
    genome once a terminal duplication is taken off (the record's tail
    repeating its head, of whatever length makes it the genome's length:
    an assembler closes a circle with an overlap of k - 1 bases or more);
    None when the record is shorter than the genome, its tail does not
    repeat its head, or no anchor is found. Contig base p is genome base
    (offset + p) mod G on orientation +1; on -1 the contig is the reverse
    complement of the genome read from ``offset``."""
    G = len(genome)
    dup = len(seq) - G
    if dup < 0 or (dup and seq[-dup:] != seq[:dup]):
        return None
    core = seq[:G]
    doubled = genome + genome
    best = None
    for orient, s in ((1, core), (-1, revcomp(core))):
        for anchor in range(0, G - 64, max(G // 16, 1)):
            at = doubled.find(s[anchor:anchor + 64])
            if at < 0:
                continue
            off = (at - anchor) % G
            ref = np.frombuffer(doubled[off:off + G].encode(), np.uint8)
            mism = int((np.frombuffer(s.encode(), np.uint8) != ref).sum())
            if best is None or mism < best[2]:
                best = (off, orient, mism)
            break
    return best


def genes_missed(planted: Dict[str, tuple], genome: str, locs: dict,
                 fragments: Dict[str, str], scaffold: str, tol: int):
    """Planted genes (not cut by the linearised circle's ends) that
    ``locs.json`` misses: absent, on the wrong strand, of the wrong kind, or
    whose annotated fragment is not a stretch of the planted gene, ``tol``
    bases of slack at each end, covering more than half of it. Two copies of
    one tRNA (trnL1, trnL2) may carry either of MitoFlex's names for them
    (trnL, trnL2). Returns (misses, cut genes, the largest end difference
    of a found gene in bases)."""
    missed, cut, worst = [], [], 0
    orient = set()
    doubled = genome + genome
    for gene, (s, e, strand, kind) in planted.items():
        want = genome[s:e]
        if want not in scaffold and revcomp(want) not in scaffold:
            cut.append(gene)
            continue
        base = gene.rstrip("0123456789") if kind == 1 else gene
        names = [n for n in locs if (n.rstrip("0123456789") if kind == 1 else n) == base]
        found = False
        for name in names:
            frag = fragments.get(name, "")
            start, end, k, _, sign = locs[name][:5]
            if not frag or end - start + 1 != len(frag) or k != kind:
                continue
            for o, x in ((1, frag), (-1, revcomp(frag))):
                at = doubled.find(x, max(s - tol, 0), e + tol)
                if at < 0 or 2 * len(frag) <= len(want) or (sign == "+") != (strand * o > 0):
                    continue
                found = True
                orient.add(o)
                worst = max(worst, abs(at - s), abs(at + len(frag) - e))
                break
            if found:
                break
        if not found:
            missed.append(gene)
    if len(orient) > 1:
        missed.append("orientation")
    return missed, cut, worst


def hits_missed(planted: Dict[str, tuple], genome: str, frame_rows: List[dict],
                contig: str, place: Tuple[int, int, int], clen: int, tol: int):
    """Planted PCGs without a profile-search hit on the circle ``contig``
    (placed by ``place``) whose span is the gene's within ``tol`` bases at
    either end, on its strand; a gene that the contig's ends cut is left
    out. Returns (missed, cut)."""
    off, orient, _ = place
    G = len(genome)
    missed, cut = [], []
    for gene, (s, e, strand, kind) in planted.items():
        if kind != 0:
            continue
        # the gene's first and last base on the contig, 0-based
        if orient == 1:
            a, b = (s - off) % G, (e - 1 - off) % G
            g_strand = strand
        else:
            a, b = (off + G - e) % G, (off + G - 1 - s) % G
            g_strand = -strand
        if b < a or b >= clen:
            cut.append(gene)
            continue
        found = False
        for r in frame_rows:
            if r["target"] != contig or r["query"] != gene:
                continue
            lo, hi = sorted((int(r["alifrom"]), int(r["alito"])))
            if (r["strand"] == "+") == (g_strand > 0) and abs(lo - 1 - a) <= tol \
                    and abs(hi - 1 - b) <= tol:
                found = True
                break
        if not found:
            missed.append(gene)
    return missed, cut
