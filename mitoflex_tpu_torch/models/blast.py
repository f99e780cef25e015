"""tblastn/blastn-equivalent translated and nucleotide homology search.

Port of mitoflex_tpu/models/blast.py. The seed index (exact k-mer join),
the window selection and the hit algebra (``blast_filter``,
``wash_blast_results``) are the reference's host code, copied because the
reference module imports jax. The candidate windows are aligned by the
port's batched Smith-Waterman (ops/sw.py) on the caller's ``device``, in
batches of 64 pairs padded only to their longest row, each batch sharded
over a ``mesh`` when one is given (parallel/mesh.py). blastn scores every
window first (``sw_scores``, one launch on a card) and aligns only those
that pass its e-value cut; on a mesh of several shards it aligns them all.

- ``tblastn``: protein DB vs six-frame-translated contigs (BLOSUM62), an
  outfmt-6 frame with nucleotide subject coordinates (sstart > send on the
  minus strand);
- ``blastn``: nucleotide vs nucleotide, both strands, exact-match seeding
  (on a card one join of every subject's windows on the device, on the CPU
  the reference's loop over subjects);
- ``blast_filter`` and ``wash_blast_results``: the reference's dedup,
  gates and greedy per-subject selection.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..io import encoding
from ..io.fasta import FastaRecord
from ..models import codon
from ..models.proteindb import ProteinRecord, parse_protein_id

from .. import device as device_mod
from ..convert import host, to_device
from ..device import resolve_device
from ..parallel import mesh as mesh_mod
from ..ops import sw as sw_ops
from ..utils import trace

OUTFMT6 = [
    "qseq", "sseq", "ident", "length", "mismatch", "gap",
    "qstart", "qend", "sstart", "send", "evalue", "score",
]

# gapped Karlin-Altschul constants
_BLOSUM62_LK = (0.267, 0.041)      # BLAST tblastn defaults (11,1)
_NT_LK = (0.625, 0.41)             # blastn megablast-ish (+2/-3)
# blastn's -evalue: the upstream wrapper runs it at 1e-5
# (MitoFlex annotation/annotation_tookit.py:117) for both merges
BLASTN_EVALUE = 1e-5
# subject bases a tensor seed join takes at once (both strands: twice as
# many windows); under 2 GB of device temporaries
_SEED_BASES = 1 << 24
# target bases a score launch takes at once: 1 GiB of codes on the device
# (the kernel's scratch has its own cap, ops/sw.SCORE_SCRATCH_BYTES)
_SCORE_BASES = 1 << 30


def _bitscore(raw: np.ndarray, lam: float, K: float) -> np.ndarray:
    return (lam * np.asarray(raw) - math.log(K)) / math.log(2)


def _evalue(bits: np.ndarray, m: float, n: float) -> np.ndarray:
    return m * n * np.exp2(-np.asarray(bits))


def _pad_rows(rows: List[np.ndarray], fill: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows padded with ``fill`` to the longest one. (The reference's
    power-of-two rows and widths only bounded XLA recompiles; padding
    changes no alignment, see ops/sw.py.)"""
    width = max((len(r) for r in rows), default=1)
    out = np.full((len(rows), max(width, 1)), fill, dtype=np.int8)
    lens = np.zeros(len(rows), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out, lens


def _batched_sw(q_rows, t_rows, submat, gap_open, gap_extend, fill, batch=64,
                device=None, mesh=None):
    """Align row i of q_rows vs row i of t_rows on ``device``; returns the
    nine SwHits fields as numpy arrays (None when there are no rows). With
    a ``mesh`` of more than one shard each batch's pairs shard over it
    (parallel.mesh.sw_align_sharded), the reference's replacement for the
    tblastn query-DB process pool; per-row results are the single-device
    kernel's."""
    dev = resolve_device(device)
    sub = torch.as_tensor(submat, dtype=torch.float32, device=dev)
    res = []
    for b0 in range(0, len(q_rows), batch):
        qs, ql = _pad_rows(q_rows[b0 : b0 + batch], fill)
        ts, tl = _pad_rows(t_rows[b0 : b0 + batch], fill)
        if mesh is not None and mesh.size > 1:
            hits = mesh_mod.sw_align_sharded(mesh, qs, ql, ts, tl, submat,
                                             gap_open, gap_extend)
        else:
            hits = sw_ops.sw_align(
                to_device(qs, dev), to_device(ql, dev), to_device(ts, dev),
                to_device(tl, dev), sub, gap_open, gap_extend,
            )
        res.append([host(x) for x in hits])
    if not res:
        return None
    return [np.concatenate([r[i] for r in res]) for i in range(9)]


def _window_scores(q_codes: Sequence[np.ndarray], qis: Sequence[int],
                   t_rows: Sequence[np.ndarray], submat, gap_open: float,
                   gap_extend: float, dev) -> np.ndarray:
    """float32 score of each window ``t_rows[i]`` against query
    ``q_codes[qis[i]]`` (``ops.sw.sw_scores``): the queries padded once, the
    windows end to end, one call a run of up to ``_SCORE_BASES`` window
    bases (a longer window alone)."""
    if not len(t_rows):
        return np.zeros(0, np.float32)
    qs, ql = _pad_rows(list(q_codes), encoding.N)
    qs, ql = to_device(qs, dev), to_device(ql, dev)
    qis = np.asarray(qis, np.int64)
    ends = np.cumsum([len(t) for t in t_rows], dtype=np.int64)
    out, a = [], 0
    while a < len(t_rows):
        base = ends[a - 1] if a else 0
        b = max(int(np.searchsorted(ends, base + _SCORE_BASES, side="right")), a + 1)
        offs = np.concatenate([[0], ends[a:b] - base])
        cat = np.concatenate(t_rows[a:b]).astype(np.int8, copy=False)
        out.append(host(sw_ops.sw_scores(
            qs, ql, to_device(qis[a:b], dev), to_device(cat, dev), to_device(offs, dev),
            submat, gap_open, gap_extend)))
        a = b
    return np.concatenate(out)


def _pack_windows(codes: np.ndarray, k: int, bits: int) -> np.ndarray:
    """All k-length windows of a code array packed into int64 keys
    (bits per symbol; k * bits must fit 63). Vectorized: k shift-or
    passes, no per-position Python."""
    c = np.asarray(codes, np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    v = np.zeros(n, np.int64)
    for j in range(k):
        v = (v << bits) | c[j : j + n]
    return v


class SeedIndex:
    """Exact k-mer seed join over query sequences (host side, vectorized).

    Replaces the reference's per-worker BLAST seeding (the Pool in
    annotation_tookit.py:74-97) — and round 1's per-position Python dict —
    with packed-integer k-mer keys and a sorted join: build = one argsort
    over all query windows; lookup = one searchsorted + run expansion per
    target. O((|Q|+|T|) log |Q|) numpy, zero Python per position."""

    def __init__(self, seqs: Sequence[np.ndarray], k: int, alphabet: int):
        self.k = k
        self.bits = max((alphabet - 1).bit_length(), 1)
        assert k * self.bits < 63, "seed too wide for int64 packing"
        vals, qis, qps = [], [], []
        for qi, s in enumerate(seqs):
            v = _pack_windows(s, k, self.bits)
            if len(v):
                vals.append(v)
                qis.append(np.full(len(v), qi, np.int32))
                qps.append(np.arange(len(v), dtype=np.int32))
        if vals:
            av = np.concatenate(vals)
            order = np.argsort(av, kind="stable")
            self.vals = av[order]
            self.qi = np.concatenate(qis)[order]
            self.qp = np.concatenate(qps)[order]
        else:
            self.vals = np.zeros(0, np.int64)
            self.qi = np.zeros(0, np.int32)
            self.qp = np.zeros(0, np.int32)

    def hits_arrays(
        self, target: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All exact seed matches as arrays (query_idx, query_pos,
        target_pos), via a two-sided searchsorted join."""
        tv = _pack_windows(target, self.k, self.bits)
        if not len(tv) or not len(self.vals):
            z = np.zeros(0, np.int32)
            return z, z, z
        lo = np.searchsorted(self.vals, tv, side="left")
        hi = np.searchsorted(self.vals, tv, side="right")
        runs = hi - lo
        total = int(runs.sum())
        if total == 0:
            z = np.zeros(0, np.int32)
            return z, z, z
        # expand each target window's run of matching DB rows
        tp = np.repeat(np.arange(len(tv), dtype=np.int32), runs)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(runs) - runs, runs
        )
        rows = np.repeat(lo, runs) + within
        return self.qi[rows], self.qp[rows], tp

    def hits(self, target: np.ndarray):
        """yield (query_idx, query_pos, target_pos) — compat shim."""
        qi, qp, tp = self.hits_arrays(target)
        yield from zip(qi.tolist(), qp.tolist(), tp.tolist())


def _group_anchor_windows(
    qi: np.ndarray, qp: np.ndarray, tp: np.ndarray, min_seeds: int
) -> List[Tuple[int, int, int]]:
    """Group seed matches by query; return (query_idx, min_diag, max_diag)
    for queries with >= min_seeds anchors. Vectorized reduceat."""
    if not len(qi):
        return []
    diag = tp.astype(np.int64) - qp.astype(np.int64)
    order = np.argsort(qi, kind="stable")
    q_s, d_s = qi[order], diag[order]
    starts = np.flatnonzero(np.concatenate([[True], q_s[1:] != q_s[:-1]]))
    counts = np.diff(np.append(starts, len(q_s)))
    mins = np.minimum.reduceat(d_s, starts)
    maxs = np.maximum.reduceat(d_s, starts)
    keep = counts >= min_seeds
    return list(zip(q_s[starts[keep]].tolist(),
                    mins[keep].tolist(), maxs[keep].tolist()))


def _seed_groups_host(seed_idx: SeedIndex, subjects: Sequence[FastaRecord],
                      min_seeds: int):
    """blastn's seed windows, subject by subject and strand by strand:
    (subject, strand, the strand's codes, query, min diag, max diag)."""
    for si, subj in enumerate(subjects):
        for strand, codes in ((1, subj.codes),
                              (-1, np.asarray(encoding.revcomp(subj.codes)))):
            aq, ap, at = seed_idx.hits_arrays(codes)
            for qi, dmin, dmax in _group_anchor_windows(aq, ap, at, min_seeds):
                yield si, strand, codes, qi, dmin, dmax


def _seed_join_tensor(idx, n_queries: int, codes: torch.Tensor, lens: torch.Tensor,
                      k: int, bits: int, min_seeds: int):
    """One seed join of a run of subjects on their device: ``codes`` the
    subjects' codes end to end, ``lens`` their lengths, ``idx`` the query
    index's (vals, qi, qp) there. Returns the kept groups' keys
    ((subject * 2 + strand) * n_queries + query, strand 0 the plus one)
    in order, their min and max diagonals and their seed counts."""
    dev = codes.device
    n = codes.numel()
    nw = 2 * n - k + 1
    if nw <= 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    vals, qi, qp = idx
    sid = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)
    off = torch.cumsum(lens, 0) - lens
    pos = torch.arange(n, device=dev) - off[sid]
    # the minus strand, subject by subject in the same places: revcomp
    minus = torch.as_tensor(encoding.COMPLEMENT, device=dev)[
        codes[off[sid] + lens[sid] - 1 - pos].long()]
    both = torch.cat([codes, minus]).long()
    key = torch.zeros(nw, dtype=torch.int64, device=dev)
    for j in range(k):
        key = (key << bits) | both[j:j + nw]
    w = torch.arange(nw, device=dev) % n
    valid = pos[w] + k <= lens[sid[w]]
    lo = torch.searchsorted(vals, key)
    runs = (torch.searchsorted(vals, key, right=True) - lo) * valid
    wsel = torch.nonzero(runs).squeeze(1)
    r = runs[wsel]
    w_hit = torch.repeat_interleave(wsel, r)
    rows = torch.repeat_interleave(lo[wsel] - (torch.cumsum(r, 0) - r), r) + torch.arange(
        w_hit.numel(), device=dev)
    strand = (w_hit >= n).long()
    g = w_hit - strand * n
    s = sid[g]
    diag = pos[g] - qp[rows]
    gkey = (s * 2 + strand) * n_queries + qi[rows]
    uk, inv, cnt = torch.unique(gkey, sorted=True, return_inverse=True, return_counts=True)
    dmin = torch.full_like(uk, 1 << 62).scatter_reduce(0, inv, diag, "amin")
    dmax = torch.full_like(uk, -(1 << 62)).scatter_reduce(0, inv, diag, "amax")
    keep = cnt >= min_seeds
    return host(uk[keep]), host(dmin[keep]), host(dmax[keep])


def _seed_groups_tensor(seed_idx: SeedIndex, n_queries: int,
                        subjects: Sequence[FastaRecord], min_seeds: int, dev):
    """:func:`_seed_groups_host`'s windows, in its order, from one seed
    join on ``dev`` a run of subjects of up to ``_SEED_BASES`` bases (a
    subject longer than that alone), both strands at once."""
    lens = np.array([len(s.seq) for s in subjects], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    cat = encoding.encode("".join(s.seq for s in subjects))
    idx = tuple(to_device(np.asarray(a, np.int64), dev)
                for a in (seed_idx.vals, seed_idx.qi, seed_idx.qp))
    a = 0
    while a < len(subjects):
        b = a + 1
        while b < len(subjects) and offs[b + 1] - offs[a] <= _SEED_BASES:
            b += 1
        keys, dmins, dmaxs = _seed_join_tensor(
            idx, n_queries, to_device(cat[offs[a]:offs[b]], dev),
            to_device(lens[a:b], dev), seed_idx.k, seed_idx.bits, min_seeds)
        minus = {}
        for key, dmin, dmax in zip(keys.tolist(), dmins.tolist(), dmaxs.tolist()):
            si = a + key // (2 * n_queries)
            codes = cat[offs[si]:offs[si + 1]]
            if (key // n_queries) % 2:
                if si not in minus:
                    minus[si] = np.asarray(encoding.revcomp(codes))
                yield si, -1, minus[si], key % n_queries, dmin, dmax
            else:
                yield si, 1, codes, key % n_queries, dmin, dmax
        a = b


def tblastn(
    db: Sequence[ProteinRecord],
    contigs: Sequence[FastaRecord],
    table_id: int,
    seed_len: int = 4,
    min_seeds: int = 2,
    gap_open: float = 12.0,   # BLAST 11 + ext 1 (see ops/sw.py convention)
    gap_extend: float = 1.0,
    window_slack: int = 30,
    device=None,
    mesh=None,
) -> pd.DataFrame:
    """Protein queries vs translated contigs → outfmt-6 frame."""
    submat = codon.blosum62()
    seed_idx = SeedIndex([r.aa_codes for r in db], seed_len, codon.NUM_AA)
    m_total = float(sum(r.length for r in db)) or 1.0

    q_rows, t_rows, meta = [], [], []
    for ci, contig in enumerate(contigs):
        codes = contig.codes
        for frame, aa in codon.six_frame_translate(codes, table_id):
            if len(aa) < seed_len:
                continue
            # seed join + per-query diagonal windows, all vectorized
            aq, ap, at = seed_idx.hits_arrays(np.asarray(aa))
            for qi, dmin, dmax in _group_anchor_windows(aq, ap, at, min_seeds):
                qlen = db[qi].length
                lo = max(dmin - window_slack, 0)
                hi = min(dmax + qlen + window_slack, len(aa))
                q_rows.append(db[qi].aa_codes)
                t_rows.append(np.asarray(aa[lo:hi]))
                meta.append((qi, ci, frame, lo))

    out = _batched_sw(q_rows, t_rows, submat, gap_open, gap_extend,
                      codon.X_CODE, device=device, mesh=mesh)
    rows = []
    if out is not None:
        score, qf, qt, tf, tt, nid, ncol, ngo, ngc = out
        lam, K = _BLOSUM62_LK
        bits = _bitscore(score, lam, K)
        for i, (qi, ci, frame, lo) in enumerate(meta):
            ncols = max(int(ncol[i]), 1)
            aa_from = lo + int(tf[i])
            aa_to = lo + int(tt[i])
            clen = len(contigs[ci].seq)
            if frame > 0:
                s_start = (frame - 1) + 3 * aa_from + 1
                s_end = (frame - 1) + 3 * aa_to + 3
            else:
                # coordinates on the reverse strand, mapped to plus strand
                rc_start = (-frame - 1) + 3 * aa_from
                rc_end = (-frame - 1) + 3 * aa_to + 2
                s_start = clen - rc_start       # 1-based, start > end
                s_end = clen - rc_end
            ev = float(_evalue(bits[i : i + 1], m_total, clen)[0])
            rows.append(
                dict(
                    qseq=db[qi].id, sseq=contigs[ci].id,
                    ident=100.0 * int(nid[i]) / ncols,
                    length=ncols,
                    mismatch=ncols - int(nid[i]) - int(ngc[i]),
                    gap=int(ngo[i]),
                    qstart=int(qf[i]) + 1, qend=int(qt[i]) + 1,
                    sstart=s_start, send=s_end,
                    evalue=ev, score=float(bits[i]),
                )
            )
    frame_df = pd.DataFrame(rows, columns=OUTFMT6)
    return frame_df


def blastn_windows(queries: Sequence[FastaRecord], subjects: Sequence[FastaRecord],
                   seed_len: int, min_seeds: int, window_slack: int, skip_self: bool, dev):
    """blastn's candidate pairs: the queries' codes, and for every seed group
    (on a card one join of every subject's windows, on the CPU the loop over
    subjects) its query's codes, its window of the subject strand and
    (query, subject, strand, window start)."""
    q_codes = [q.codes for q in queries]
    seed_idx = SeedIndex(q_codes, seed_len, 5)
    if device_mod.uses_host_mirrors(dev) or not len(seed_idx.vals):
        groups = _seed_groups_host(seed_idx, subjects, min_seeds)
    else:
        groups = _seed_groups_tensor(seed_idx, len(queries), subjects, min_seeds, dev)
    q_rows, t_rows, meta = [], [], []
    for si, strand, codes, qi, dmin, dmax in groups:
        if skip_self and strand == 1 and queries[qi].id == subjects[si].id:
            continue
        qlen = len(q_codes[qi])
        lo = max(dmin - window_slack, 0)
        hi = min(dmax + qlen + window_slack, len(codes))
        q_rows.append(q_codes[qi])
        t_rows.append(codes[lo:hi])
        meta.append((qi, si, strand, lo))
    return q_codes, q_rows, t_rows, meta


def blastn(
    queries: Sequence[FastaRecord],
    subjects: Sequence[FastaRecord],
    seed_len: int = 11,
    min_seeds: int = 1,
    gap_open: float = 7.0,
    gap_extend: float = 2.0,
    window_slack: int = 50,
    skip_self: bool = False,
    device=None,
    mesh=None,
) -> pd.DataFrame:
    """Nucleotide vs nucleotide → outfmt-6 frame (both strands).

    A row's e-value is reckoned as blastn reckons it against a database
    made of the subjects: query length x the subjects' summed length x
    2^-bits; rows above ``BLASTN_EVALUE`` are dropped. The cut reads the
    score alone, so every window is scored first (``ops.sw.sw_scores``) and
    only the rows that pass it are aligned for their envelopes and path
    counts (``_batched_sw``); the frame is the one aligning every window
    would give. On a ``mesh`` of several shards every window is aligned,
    sharded. Spans ``blastn.seed`` (counters ``blastn.subjects``,
    ``blastn.pairs``, ``blastn.cells``), ``blastn.sw`` (``blastn.score``
    inside, ``blastn.score_pairs``, ``blastn.path_pairs``: the pairs scored
    and aligned) and ``blastn.frame`` (``blastn.rows`` before the cut,
    ``blastn.rows_cut``)."""
    submat = sw_ops.nucleotide_matrix()
    dev = resolve_device(device)
    with trace.span("blastn.seed"):
        q_codes, q_rows, t_rows, meta = blastn_windows(queries, subjects, seed_len, min_seeds,
                                                       window_slack, skip_self, dev)
        trace.count("blastn.subjects", len(subjects))
        trace.count("blastn.pairs", len(q_rows))
        if trace.recording():  # the sum is made only where it is kept
            trace.count("blastn.cells", sum(len(q) * len(t) for q, t in zip(q_rows, t_rows)))

    sharded = mesh is not None and mesh.size > 1
    with trace.span("blastn.sw"):
        if sharded:
            out = _batched_sw(q_rows, t_rows, submat, gap_open, gap_extend,
                              encoding.N, device=device, mesh=mesh)
            score = out[0] if out is not None else np.zeros(0, np.float32)
        else:
            with trace.span("blastn.score"):
                score = _window_scores(q_codes, [m[0] for m in meta], t_rows, submat,
                                       gap_open, gap_extend, dev)
            trace.count("blastn.score_pairs", len(meta))
        lam, K = _NT_LK
        bits = _bitscore(score, lam, K)
        m_total = float(sum(len(q.seq) for q in queries)) or 1.0
        n_total = float(sum(len(s.seq) for s in subjects)) or 1.0
        evalues = _evalue(bits, m_total, n_total)
        kept = np.flatnonzero(evalues <= BLASTN_EVALUE)
        if sharded:
            paths = [f[kept] for f in out[1:]] if out is not None else []
        else:
            trace.count("blastn.path_pairs", len(kept))
            # a row's fields do not depend on the rows batched with it
            out = _batched_sw([q_rows[i] for i in kept], [t_rows[i] for i in kept], submat,
                              gap_open, gap_extend, encoding.N, device=device)
            paths = out[1:] if out is not None else []
    rows = []
    with trace.span("blastn.frame"):
        for k, i in enumerate(kept):
            qi, si, strand, lo = meta[i]
            qf, qt, tf, tt, nid, ncol, ngo, ngc = (int(f[k]) for f in paths)
            ncols = max(ncol, 1)
            clen = len(subjects[si].seq)
            a = lo + tf
            b = lo + tt
            if strand == 1:
                s_start, s_end = a + 1, b + 1
            else:
                s_start, s_end = clen - a, clen - b  # start > end
            rows.append(
                dict(
                    qseq=queries[qi].id, sseq=subjects[si].id,
                    ident=100.0 * nid / ncols,
                    length=ncols, mismatch=ncols - nid - ngc,
                    gap=ngo,
                    qstart=qf + 1, qend=qt + 1,
                    sstart=s_start, send=s_end,
                    evalue=float(evalues[i]), score=float(bits[i]),
                )
            )
        if meta:
            trace.count("blastn.rows", len(meta))
            trace.count("blastn.rows_cut", len(meta) - len(rows))
    return pd.DataFrame(rows, columns=OUTFMT6)


# ------------------------------------------------------------- hit algebra
def blast_filter(
    frame: pd.DataFrame, ident: float = 30, score: float = 25, qcover: float = 0.25
) -> pd.DataFrame:
    """blast_to_csv semantics (annotation_tookit.py:146-168): dedup,
    identity/score gates, and the query-coverage gate against qmax (which
    the reference only maxes over queries with >2 hits)."""
    if frame.empty:
        return frame
    f = frame.drop_duplicates(keep="first")
    f = f[f.ident > ident]
    f = f[f.score > score]
    if f.empty:
        return f
    f = f.copy()
    f["qmax"] = f.groupby("qseq")["qend"].transform(
        lambda x: max(x) if x.count() > 2 else x
    )
    f = f[f.qend - f.qstart >= f.qmax * qcover]
    return f.drop(columns=["qmax"])


def gene_of_qseq(qseq: str) -> str:
    return parse_protein_id(qseq)["gene"]


def wash_blast_results(
    frame: pd.DataFrame, overlap_ratio: float = 0.2, mut_plus: bool = True
) -> pd.DataFrame:
    """Greedy per-subject non-overlap selection
    (annotation_tookit.py:172-222). Adds a 'plus' strand column, normalizes
    sstart<send, then repeatedly takes the highest-scoring hit per subject
    and drops hits overlapping it by more than overlap_ratio *
    min(length) — with zero tolerance when the overlapping hit is the SAME
    gene (fragment-border ambiguity)."""
    if frame.empty:
        raise RuntimeError(
            "Empty blast frame! No significant result found in blast."
        )
    f = frame.copy()
    if mut_plus:
        f["plus"] = (f.send - f.sstart) > 0
    lo = np.minimum(f.sstart, f.send)
    hi = np.maximum(f.sstart, f.send)
    f["sstart"], f["send"] = lo, hi

    results = []
    for _, sub in f.groupby("sseq"):
        sub = sub.sort_values("sstart", kind="stable")
        while not sub.empty:
            highest = sub[sub.score == sub.score.max()].head(1)
            results.append(highest)
            max_len = int(highest.send.iloc[0] - highest.sstart.iloc[0]) + 1
            max_start = int(highest.sstart.iloc[0]) + 1
            max_end = int(highest.send.iloc[0])
            max_gene = gene_of_qseq(str(highest.qseq.iloc[0]))
            sub = sub.drop(highest.index)
            if sub.empty:
                break
            # the reference tests substring CONTAINMENT of the gene token
            # (annotation_tookit.py:212 `~frame.qseq.str.contains(max_gene)`),
            # so ND4 also zero-tolerances ND4L hits — reproduced on purpose.
            conf = ~sub.qseq.str.contains(max_gene, regex=False)
            conf = conf.map(lambda x: max_len if x else 0)
            cutoffs = np.minimum(max_len, sub.send - sub.sstart)
            cutoffs = np.minimum(cutoffs, conf) * overlap_ratio
            overlays = np.minimum(sub.send, max_end) - np.maximum(sub.sstart, max_start)
            sub = sub[overlays <= cutoffs]
    return pd.concat(results) if results else frame
