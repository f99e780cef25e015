"""Read-to-contig seed-vote mapping.

Port of mitoflex_tpu/ops/mapper.py (``ContigIndex``, ``MappedBatch``,
``map_batch``, ``_map_device``, ``_map_host``). The contig set is indexed by
exact 15-mers (30-bit keys) sorted with their (contig, position); every
sampled read 15-mer on both strands resolves to up to ``max_mult``
candidates (the LAST rows of its key run), candidates vote per read on
(contig, diagonal), and the longest run wins if it reaches ``min_votes``
and strictly beats the runner-up.

The reference's gather-free sort-joins (``_rank_join``, ``_fetch_rows``)
were TPU workarounds; ``_map_device`` resolves seeds with
``torch.searchsorted`` and gathers, in the formulation of ``_map_host``, and
its placements are bit-identical to both of the reference's paths.

``coverage_of_reads`` (with the host helpers ``add_coverage`` and
``finish_coverage``) maps every read batch and returns per-base depth and
the mean depth of each contig, the reference's remapping for contigs that
carry no depth tag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..io import encoding
from ..io.fasta import FastaRecord

from .. import device as device_mod
from ..convert import host, to_device
from . import kmer as kmer_ops
from ..parallel import mesh as mesh_mod

K = 15
SEED_STEP = 4
MAX_MULT = 4
_MISS = 2**28
_BIAS = 1 << 32


@dataclass
class ContigIndex:
    """Sorted 15-mer index of the contig set, on the run's device."""

    ids: List[str]
    lengths: np.ndarray        # [n_contigs] int64
    keys: torch.Tensor         # [n_entries] int64 sorted 30-bit keys
    contig_of: torch.Tensor    # [n_entries] int64
    pos_of: torch.Tensor       # [n_entries] int64
    n_entries: int

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @classmethod
    def build(cls, contigs: Sequence[FastaRecord], device=None) -> "ContigIndex":
        maxlen = max([K] + [len(r.seq) for r in contigs])
        B = len(contigs)
        batch = np.full((max(B, 1), maxlen), encoding.N, np.int8)
        lens = np.zeros(max(B, 1), np.int32)
        for i, r in enumerate(contigs):
            batch[i, : len(r.seq)] = r.codes
            lens[i] = len(r.seq)
        w, v = _host_windows_u32(batch, lens, K)
        # 15-mers left-align to bits 2..31; drop the two zero low bits so
        # keys are the true 30-bit values
        w = w >> np.uint32(2)
        ridx, cidx = np.nonzero(v)
        keys = w[ridx, cidx]
        order = np.argsort(keys, kind="stable")
        dev = device_mod.resolve_device(device)

        def t(x):
            return torch.from_numpy(x[order].astype(np.int64)).to(dev)

        return cls(
            [r.id for r in contigs],
            np.asarray([len(r.seq) for r in contigs], np.int64),
            t(keys), t(ridx), t(cidx), len(keys),
        )


@dataclass
class MappedBatch:
    contig: np.ndarray     # [B] int32, -1 = unmapped
    pos: np.ndarray        # [B] int32 leftmost ref position (clamped >= 0)
    strand: np.ndarray     # [B] int8 (+1/-1)
    votes: np.ndarray      # [B] int32 supporting seeds
    raw_pos: np.ndarray    # [B] int32 unclamped (negative: 5' overhang)


def _host_windows_u32(seqs: np.ndarray, lengths: np.ndarray, k: int):
    """Numpy mirror of extract_kmers for W == 1 (k <= 16): [B, P] uint32
    left-aligned window keys + validity (inside content, N-free)."""
    B, L = seqs.shape
    P = L - k + 1
    cc = np.where(seqs < 4, seqs, 0).astype(np.uint32)
    acc = np.zeros((B, P), np.uint32)
    for t in range(k):
        acc |= cc[:, t : t + P] << np.uint32(2 * (kmer_ops.BASES_PER_WORD - 1 - t))
    is_n = (seqs == encoding.N).astype(np.int32)
    cum = np.cumsum(is_n, axis=1)
    hi = cum[:, k - 1 :]
    lo = np.pad(cum[:, : P - 1], ((0, 0), (1, 0)))
    col = np.arange(P, dtype=np.int32)[None, :]
    valid = (col + k <= lengths[:, None]) & (hi - lo == 0)
    return acc, valid


def _map_host(index: ContigIndex, seqs: np.ndarray, lengths: np.ndarray,
              min_votes: int, step: int, max_mult: int):
    """Numpy mapper (the CPU device's path): searchsorted against the small
    index."""
    B, L = seqs.shape
    comp = np.where(seqs < 4, 3 - seqs, seqs).astype(np.int8)
    rev = comp[:, ::-1]
    col = np.arange(L, dtype=np.int32)[None, :]
    src = np.clip(col + (L - lengths[:, None]), 0, L - 1)
    rc = np.take_along_axis(rev, src, axis=1)
    rc = np.where(col < lengths[:, None], rc, np.int8(encoding.N))
    both = np.concatenate([seqs, rc])
    lens2 = np.concatenate([lengths, lengths])

    w, v = _host_windows_u32(both, lens2, K)
    w = (w >> np.uint32(2))[:, ::step]
    v = v[:, ::step]
    S = w.shape[1]
    offs = np.arange(S, dtype=np.int64) * step

    tk = host(index.keys)
    con_of = host(index.contig_of)
    pos_of = host(index.pos_of)
    q = w.reshape(-1).astype(np.int64)
    qv = v.reshape(-1)
    lo = np.searchsorted(tk, q, side="left")
    hi = np.searchsorted(tk, q, side="right")
    # the LAST max_mult index rows of each key's run
    rows = (hi - 1)[:, None] - np.arange(max_mult, dtype=np.int64)[None, :]
    okc = (rows >= lo[:, None]) & qv[:, None] & (hi > lo)[:, None]
    rows_s = np.clip(rows, 0, len(tk) - 1)
    con = np.where(okc, con_of[rows_s], _MISS)
    tp = np.where(okc, pos_of[rows_s], 0)
    diag = np.where(okc, tp - np.tile(offs, 2 * B)[:, None], _MISS)

    # per-read voting: pack (contig, diag) into one int64 and sort rows
    key = (con << np.int64(33)) + diag + _BIAS
    key = key.reshape(2 * B, S * max_mult)
    key.sort(axis=1)
    M = key.shape[1]
    con_s = key >> np.int64(33)
    diag_s = (key & ((np.int64(1) << np.int64(33)) - 1)) - _BIAS
    pos_i = np.broadcast_to(np.arange(M, dtype=np.int64)[None, :], key.shape)
    same = key[:, 1:] == key[:, :-1]
    is_new = np.concatenate([np.ones((2 * B, 1), bool), ~same], axis=1)
    run_start = np.maximum.accumulate(np.where(is_new, pos_i, 0), axis=1)
    run_len = pos_i - run_start + 1
    run_len = np.where(con_s < _MISS, run_len, 0)
    is_end = np.concatenate([~same, np.ones((2 * B, 1), bool)], axis=1)
    end_len = np.where(is_end, run_len, 0)
    best_votes = end_len.max(axis=1)
    best_idx = end_len.argmax(axis=1)
    second_votes = np.where(
        pos_i == best_idx[:, None], np.int64(-1), end_len
    ).max(axis=1)
    contig = np.take_along_axis(con_s, best_idx[:, None], axis=1)[:, 0]
    diag_w = np.take_along_axis(diag_s, best_idx[:, None], axis=1)[:, 0]
    ok = (best_votes >= min_votes) & (best_votes > second_votes)
    contig = np.where(ok, contig, -1)
    raw = diag_w
    pos = np.maximum(diag_w, 0)

    c_f, c_r = contig[:B], contig[B:]
    p_f, p_r = pos[:B], pos[B:]
    r_f, r_r = raw[:B], raw[B:]
    v_f, v_r = best_votes[:B], best_votes[B:]
    use_r = v_r > v_f
    return (
        np.where(use_r, c_r, c_f).astype(np.int32),
        np.where(use_r, p_r, p_f).astype(np.int32),
        np.where(use_r, np.int8(-1), np.int8(1)),
        np.where(use_r, v_r, v_f).astype(np.int32),
        np.where(use_r, r_r, r_f).astype(np.int32),
    )


def _map_device(keys: torch.Tensor, contig_of: torch.Tensor, pos_of: torch.Tensor,
                seqs: torch.Tensor, lengths: torch.Tensor, min_votes: int = 2,
                step: int = SEED_STEP, max_mult: int = MAX_MULT):
    """Tensor mapper: both strands in one pass; returns (contig, pos,
    strand, votes, raw) tensors for the B reads."""
    dev = seqs.device
    B, L = seqs.shape
    rc = kmer_ops.revcomp_codes(seqs, lengths)
    both = torch.cat([seqs, rc])
    lens2 = torch.cat([lengths, lengths])
    words, valid = kmer_ops.extract_kmers(both, lens2, K)
    w = ((words[0].to(torch.int64) & 0xFFFFFFFF) >> 2)[:, ::step]
    v = valid[:, ::step]
    S = w.shape[1]
    offs = torch.arange(S, device=dev) * step
    q = w.reshape(-1).contiguous()
    qv = v.reshape(-1)
    lo = torch.searchsorted(keys, q)
    hi = torch.searchsorted(keys, q, right=True)
    rows = (hi - 1)[:, None] - torch.arange(max_mult, device=dev)[None, :]
    okc = (rows >= lo[:, None]) & qv[:, None] & (hi > lo)[:, None]
    rows_s = rows.clamp(0, keys.shape[0] - 1)
    con = torch.where(okc, contig_of[rows_s], _MISS)
    tp = torch.where(okc, pos_of[rows_s], 0)
    diag = torch.where(okc, tp - offs.repeat(2 * B)[:, None], _MISS)
    # per-read voting over (contig, diagonal), as _map_host does
    key = torch.sort(((con << 33) + diag + _BIAS).reshape(2 * B, S * max_mult),
                     dim=1).values
    M = key.shape[1]
    con_s = key >> 33
    diag_s = (key & ((1 << 33) - 1)) - _BIAS
    pos_i = torch.arange(M, device=dev)[None, :]
    same = key[:, 1:] == key[:, :-1]
    edge = torch.ones((2 * B, 1), dtype=torch.bool, device=dev)
    is_new = torch.cat([edge, ~same], dim=1)
    run_start = torch.cummax(torch.where(is_new, pos_i, 0), dim=1).values
    run_len = torch.where(con_s < _MISS, pos_i - run_start + 1, 0)
    end_len = torch.where(torch.cat([~same, edge], dim=1), run_len, 0)
    best_votes = end_len.max(dim=1).values
    best_idx = torch.argmax(end_len, dim=1)  # first maximum, like numpy
    second_votes = torch.where(pos_i == best_idx[:, None], -1, end_len).max(dim=1).values
    contig = torch.gather(con_s, 1, best_idx[:, None])[:, 0]
    raw = torch.gather(diag_s, 1, best_idx[:, None])[:, 0]
    ok = (best_votes >= min_votes) & (best_votes > second_votes)
    contig = torch.where(ok, contig, -1)
    pos = raw.clamp(min=0)
    use_r = best_votes[B:] > best_votes[:B]

    def pick(x):
        return torch.where(use_r, x[B:], x[:B])

    strand = torch.where(use_r, -1, 1)
    return pick(contig), pick(pos), strand, pick(best_votes), pick(raw)


def map_batch(
    index: ContigIndex,
    seqs: np.ndarray,
    lengths: np.ndarray,
    min_votes: int = 2,
    sample_step: int = SEED_STEP,
    max_key_mult: int = MAX_MULT,
    mesh=None,
) -> MappedBatch:
    """Place a numpy batch of reads on the index's device. With a ``mesh``
    (parallel/mesh.py) of more than one shard the reads shard over it, the
    index replicated, each shard through the tensor mapper on every device
    type (parallel.mesh.map_reads_sharded); the placements are the
    single-device ones."""
    B, L = seqs.shape
    if B == 0 or L < K or index.n_entries == 0:
        return MappedBatch(
            np.full(B, -1, np.int32), np.zeros(B, np.int32),
            np.ones(B, np.int8), np.zeros(B, np.int32), np.zeros(B, np.int32),
        )
    lengths = np.asarray(lengths)
    # columns past the longest read hold only invalid windows
    seqs = np.asarray(seqs)[:, : max(int(lengths.max(initial=0)), K)]
    if mesh is not None and mesh.size > 1:
        res = mesh_mod.map_reads_sharded(
            mesh, index.keys, index.contig_of, index.pos_of, seqs, lengths,
            min_votes, sample_step, max_key_mult,
        )
    elif not device_mod.uses_host_mirrors(index.device):
        dev = index.device
        res = _map_device(
            index.keys, index.contig_of, index.pos_of, to_device(seqs, dev),
            to_device(lengths, dev), min_votes, sample_step, max_key_mult,
        )
    else:
        res = None
    if res is None:
        out = _map_host(index, seqs, lengths, min_votes, sample_step, max_key_mult)
    else:
        contig, pos, strand, votes, raw = (host(x) for x in res)
        out = (contig.astype(np.int32), pos.astype(np.int32),
               strand.astype(np.int8), votes.astype(np.int32),
               raw.astype(np.int32))
    return MappedBatch(*out)


def add_coverage(
    depth: List[np.ndarray], index: ContigIndex, mapped: MappedBatch, lengths: np.ndarray
) -> None:
    """Accumulate per-base depth via difference arrays (host)."""
    sel = np.nonzero(mapped.contig >= 0)[0]
    cis = mapped.contig[sel]
    for ci in np.unique(cis):
        rows = sel[cis == ci]
        d = depth[int(ci)]
        np.add.at(d, mapped.pos[rows], 1)
        e = np.minimum(mapped.pos[rows] + lengths[rows], len(d) - 1)
        np.add.at(d, e, -1)


def finish_coverage(depth: List[np.ndarray]) -> List[np.ndarray]:
    return [np.cumsum(d[:-1]) if len(d) else d for d in depth]


def coverage_of_reads(
    contigs: Sequence[FastaRecord],
    batches,
    min_votes: int = 2,
    device=None,
    mesh=None,
) -> Tuple[List[np.ndarray], Dict[str, float], int, int]:
    """Map all read batches (each with ``seqs``, ``lengths`` and ``count``)
    on ``device``, or sharded over ``mesh``; returns (per-contig depth
    arrays, contig id -> mean depth, n_mapped, n_total)."""
    index = ContigIndex.build(contigs, device)
    depth = [np.zeros(int(n) + 1, np.int64) for n in index.lengths]
    n_mapped = n_total = 0
    for batch in batches:
        count = batch.count
        mapped = map_batch(index, batch.seqs[:count], batch.lengths[:count], min_votes,
                           mesh=mesh)
        add_coverage(depth, index, mapped, batch.lengths[:count])
        n_mapped += int((mapped.contig >= 0).sum())
        n_total += count
    per_base = finish_coverage(depth)
    means = {
        index.ids[i]: float(per_base[i].mean()) if len(per_base[i]) else 0.0
        for i in range(len(index.ids))
    }
    return per_base, means, n_mapped, n_total
