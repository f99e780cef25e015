"""nhmmer-equivalent profile search.

Port of mitoflex_tpu/models/nhmmer.py: contigs are cut into overlapping
windows per profile shape bucket, scanned on both strands by the port's
Viterbi (ops/phmm.py) on the caller's ``device``, and surviving hits come
out as the reference's tblout-compatible frame:

    target  query  hmmfrom  hmmto  alifrom  alito  sqlen  strand  e  score

The window grouping is the reference's, ``(Lp, T)`` buckets, window length
and overlap included, because it decides which hits exist. Two things only
bounded XLA recompiles and are dropped: the power-of-two padding of the
window batches, and scanning all T columns of a batch whose windows are all
shorter (columns past every window's length change no score; the scans run
to the longest window of the batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import pandas as pd

from ..io import encoding
from ..io.fasta import FastaRecord
from ..models.hmm import ProfileHMM
from ..utils import trace
from ..utils.logger import logger

from ..convert import host, to_device
from ..device import resolve_device
from ..parallel import mesh as mesh_mod
from ..ops import phmm as phmm_ops

TBLOUT_COLUMNS = [
    "target", "query", "hmmfrom", "hmmto", "alifrom", "alito",
    "sqlen", "strand", "e", "score",
]


@dataclass
class _Window:
    contig_idx: int
    strand: int       # +1 / -1
    offset: int       # start of window within the (oriented) sequence
    length: int


def _windows_for(length: int, win: int, overlap: int) -> List[Tuple[int, int]]:
    if length <= win:
        return [(0, length)]
    out = []
    step = win - overlap
    s = 0
    while s < length:
        e = min(s + win, length)
        out.append((s, e - s))
        if e == length:
            break
        s += step
    return out


def _scores_multi(stack, model_lens, seqs, lens, device, mesh=None) -> np.ndarray:
    """Pass 1: every model of the group scores every window, [M, B];
    sharded over the windows when a mesh of more than one shard is given
    (parallel.mesh.viterbi_scores_multi_sharded), bit-identical per window
    to the single-device sweep."""
    if mesh is not None and mesh.size > 1:
        return host(mesh_mod.viterbi_scores_multi_sharded(mesh, stack, model_lens,
                                                          seqs, lens))
    return host(phmm_ops.viterbi_scores_multi(
        stack, model_lens, to_device(seqs, device), to_device(lens, device)))


def _scan(prof, seqs, lens, model_len, device, mesh=None) -> phmm_ops.HmmHits:
    """Pass 2: envelopes of one model, as numpy arrays; sharded over the
    windows when a mesh of more than one shard is given."""
    if mesh is not None and mesh.size > 1:
        hits = mesh_mod.viterbi_scan_sharded(mesh, prof, seqs, lens, model_len)
    else:
        hits = phmm_ops.viterbi_scan(prof, to_device(seqs, device),
                                     to_device(lens, device), model_len)
    return phmm_ops.HmmHits(*(host(x) for x in hits))


def nhmmer_search(
    contigs: Sequence[FastaRecord],
    profiles: Sequence[ProfileHMM],
    e_threshold: float = 1e-3,
    score_threshold: float = 0.0,
    batch_windows: int = 512,
    device=None,
    mesh=None,
) -> pd.DataFrame:
    """Scan every contig (both strands) against every profile.

    Profiles that share a (padded model length, window) bucket are stacked
    and scored together (pass 1); windows that pass are rescanned per model
    for envelopes (pass 2), with the reference's mask-and-rescan multihit
    rounds. Overlapping windows reporting one alignment are deduplicated
    as the reference does. With a ``mesh`` of more than one shard both
    passes shard the windows over it, the profiles replicated; the frame is
    the single-device one."""
    dev = resolve_device(device)
    rows: List[dict] = []
    codes = [c.codes for c in contigs]
    rc_codes = [np.asarray(encoding.revcomp(x)) for x in codes]
    total_bases = float(sum(len(x) for x in codes)) or 1.0

    staged = [(hmm, phmm_ops.stage_profile(hmm, device=dev)) for hmm in profiles]
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (hmm, prof) in enumerate(staged):
        L = hmm.length
        win = min(max(2 * L, 512), 8192)
        T = 512
        while T < win:
            T <<= 1
        Lp = prof.msc.shape[0]
        groups.setdefault((Lp, T), []).append(i)

    for (Lp, T), idxs in groups.items():
        Lmax = max(staged[i][0].length for i in idxs)
        win = min(min(max(2 * Lmax, 512), 8192), T)
        overlap = min(Lmax, win // 2)

        windows: List[_Window] = []
        with trace.span("nhmmer.window"):
            for ci, c in enumerate(codes):
                for strand, arr in ((1, codes[ci]), (-1, rc_codes[ci])):
                    for off, wl in _windows_for(len(arr), win, overlap):
                        windows.append(_Window(ci, strand, off, wl))

        stack = phmm_ops.stack_profiles([staged[i][1] for i in idxs])
        model_lens = [staged[i][0].length for i in idxs]

        for b0 in range(0, len(windows), batch_windows):
            chunk = windows[b0 : b0 + batch_windows]
            B = len(chunk)
            with trace.span("nhmmer.window"):
                width = max(max(w.length for w in chunk), 1)
                seqs = np.full((B, width), encoding.N, dtype=np.int8)
                lens = np.zeros(B, np.int32)
                for i, w in enumerate(chunk):
                    arr = codes[w.contig_idx] if w.strand == 1 else rc_codes[w.contig_idx]
                    seqs[i, : w.length] = arr[w.offset : w.offset + w.length]
                    lens[i] = w.length
            with trace.span("nhmmer.v1"):
                pre_all = _scores_multi(stack, model_lens, seqs, lens, dev, mesh)  # [M, B]
            for mi, i_model in enumerate(idxs):
                hmm, prof = staged[i_model]
                L = hmm.length
                mu, lam = hmm.stats.get("VITERBI", (0.0, 0.7))
                n_targets = max(total_bases / max(L, 1), 1.0)
                # pass 1 has no envelope yet: the least negative length
                # correction keeps it permissive; pass 2 corrects exactly
                pre = pre_all[mi] + phmm_ops.length_correction_bits(
                    lens, np.minimum(lens, 2 * L)
                )
                pre_eval = phmm_ops.evalue(pre, mu, lam, n_targets)
                passing = [
                    i for i in range(B)
                    if pre[i] >= score_threshold and pre_eval[i] <= e_threshold
                ]
                if not passing:
                    continue
                seqs2 = seqs[passing].copy()
                lens2 = lens[passing].copy()
                # multihit: mask each reported envelope and rescan, so several
                # same-model copies in one window all come out
                active = list(range(len(passing)))
                for _round in range(4):
                    if not active:
                        break
                    with trace.span("nhmmer.v2"):
                        hits = _scan(prof, seqs2, lens2, L, dev, mesh)
                    sf, st = hits.seq_from, hits.seq_to
                    score = hits.score + phmm_ops.length_correction_bits(
                        lens2, st - sf + 1
                    )
                    score = score - phmm_ops.null2_bias_bits(seqs2, sf, st)
                    evals = phmm_ops.evalue(score, mu, lam, n_targets)
                    next_active = []
                    for j in active:
                        i = passing[j]
                        if score[j] < score_threshold or evals[j] > e_threshold:
                            continue
                        w = chunk[i]
                        clen = len(codes[w.contig_idx])
                        a = w.offset + int(sf[j])  # 0-based in oriented seq
                        b = w.offset + int(st[j])
                        if w.strand == 1:
                            alifrom, alito = a + 1, b + 1
                        else:
                            alifrom, alito = clen - a, clen - b  # from > to
                        rows.append(
                            dict(
                                target=contigs[w.contig_idx].id,
                                query=hmm.name,
                                hmmfrom=int(hits.hmm_from[j]),
                                hmmto=int(hits.hmm_to[j]),
                                alifrom=alifrom,
                                alito=alito,
                                sqlen=clen,
                                strand="+" if w.strand == 1 else "-",
                                e=float(evals[j]),
                                score=float(score[j]),
                            )
                        )
                        if st[j] >= sf[j] and st[j] - sf[j] + 1 < lens2[j]:
                            seqs2[j, sf[j] : st[j] + 1] = encoding.N
                            next_active.append(j)
                    keep_rows = set(next_active)
                    for j in range(len(passing)):
                        if j not in keep_rows:
                            lens2[j] = 0
                    active = next_active

    with trace.span("nhmmer.frame"):
        frame = _hit_frame(rows)
    logger.debug(f"nhmmer_search: {len(frame)} hits over {len(contigs)} contigs")
    return frame


def _hit_frame(rows: List[dict]) -> pd.DataFrame:
    """The hits as a tblout frame, each alignment once."""
    frame = pd.DataFrame(rows, columns=TBLOUT_COLUMNS)
    if frame.empty:
        return frame
    # overlapping windows can report one alignment twice: keep the best
    # score per (target, query, strand, overlapping span)
    frame = frame.sort_values("score", ascending=False, kind="stable")
    kept: List[int] = []
    spans: Dict[Tuple[str, str, str], List[Tuple[int, int]]] = {}
    for idx, row in frame.iterrows():
        lo, hi = sorted((row.alifrom, row.alito))
        key = (row.target, row.query, row.strand)
        overlapped = False
        for (plo, phi) in spans.get(key, []):
            inter = min(hi, phi) - max(lo, plo) + 1
            if inter > 0.5 * min(hi - lo + 1, phi - plo + 1):
                overlapped = True
                break
        if overlapped:
            continue
        spans.setdefault(key, []).append((lo, hi))
        kept.append(idx)
    return frame.loc[kept].reset_index(drop=True)
