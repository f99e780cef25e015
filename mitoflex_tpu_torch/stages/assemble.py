"""Assemble stage: clean reads -> contig FASTA through a multi-k de Bruijn
loop.

Port of mitoflex_tpu/stages/assemble.py. Per k: chunked k-mer counting
into a device-resident LSM (``KmerCounter``: per-chunk scattered runs merged
by the CUDA merge kernel on a card), the solid gate, the graph + unitig
pass, the graph-cleaning fixpoint (the host numpy ``stages/graph_clean``),
local extension of contig ends through the seed-vote mapper, and the
inter-iteration depth filter with contig re-injection at the next k. The
run's ``device`` is passed down explicitly; on the CPU the host
formulations run (device.uses_host_mirrors). With a ``mesh``
(parallel/mesh.py) of more than one shard the counting
(``ShardedKmerCounter``), the mercy pass and the read mapping shard over it
in their tensor formulations, and so does the graph pass on cards
(parallel/graph_mesh.py); the contigs are the single-device run's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AssembleConfig
from ..io import encoding, fasta, fastq
from ..io.prefetch import prefetch
from ..stages import graph_clean
from ..utils import trace
from ..utils.helper import timed
from ..utils.logger import logger

from .. import device as device_mod
from ..convert import host, to_device, u32_numpy
from ..ops import dbg as dbg_ops
from ..ops import kmer as kmer_ops
from ..ops import mapper as mapper_ops
from ..parallel import mesh as mesh_mod


class EmptyGraph(Exception):
    """No solid edges at this k (reference assemble_wrapper.py:43)."""


@dataclass
class Contig:
    seq: str
    depth: float
    circular: bool

    @property
    def flag(self) -> int:
        return 1 if self.circular else 0


class KmerCounter:
    """Chunked k-mer counting with a device-resident LSM.

    On a CUDA device each unweighted chunk yields a SCATTERED run
    (count_chunk_scattered: one sort, no compaction) and runs merge pairwise
    like a binary counter with a pure sorted merge (merge_scattered, the
    CUDA merge kernel); per-key totals are re-summed once at extraction
    (pull_scattered, uint64 on the host). A merge whose output would exceed
    ``max_device_rows`` spills both runs to the host LSM
    (merge_sorted_counts). On the CPU each chunk is counted and merged on
    the host. Weighted chunks (contig re-injection) always take the exact
    host-table path. Past ``spill_rows`` host rows the host LSM moves to
    disk buckets (ops/spill.py) and :meth:`merged_iter` merges
    one key range at a time."""

    def __init__(self, k: int, canonical: bool = False,
                 max_device_rows: int = 1 << 26,
                 spill_rows: int = 1 << 27, spill_dir: Optional[str] = None,
                 spill_buckets: int = 64, device=None):
        self.k = k
        self.canonical = canonical
        self.max_device_rows = max_device_rows
        self.device = device_mod.resolve_device(device)
        self.prefer_host = device_mod.uses_host_mirrors(self.device)
        self.spill_rows = spill_rows
        self.spill_dir = spill_dir
        self.spill_buckets = spill_buckets
        self._levels: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        self._dev_levels: List[Optional[tuple]] = []  # scattered (words, counts)
        self._spill = None
        self._host_rows = 0
        self.peak_host_rows = 0
        self._cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._cache_valid = False

    def _note_host_rows(self, extra: int = 0) -> None:
        self._host_rows = sum(len(r[1]) for r in self._levels if r is not None)
        self.peak_host_rows = max(self.peak_host_rows, self._host_rows + extra)

    def _activate_spill(self) -> None:
        from ..ops.spill import BucketSpill

        self._spill = BucketSpill(
            kmer_ops.num_words(self.k), self.spill_buckets, self.spill_dir,
            canonical=self.canonical,
        )
        for run in self._levels:
            if run is not None:
                self._spill.append(run[0], run[1])
        self._levels = []
        self._note_host_rows()
        logger.info(
            f"kmer counter: host LSM spilling to disk ({self._spill.dir}, "
            f"{self.spill_buckets} buckets)"
        )

    def _push(self, run: Tuple[np.ndarray, np.ndarray]) -> None:
        self._cache_valid = False
        if self._spill is not None:
            self.peak_host_rows = max(self.peak_host_rows, len(run[1]))
            self._spill.append(run[0], run[1])
            return
        level = 0
        while True:
            if level == len(self._levels):
                self._levels.append(run)
                break
            if self._levels[level] is None:
                self._levels[level] = run
                break
            a = self._levels[level]
            self._levels[level] = None
            run = kmer_ops.merge_sorted_counts(a[0], a[1], run[0], run[1])
            level += 1
        self._note_host_rows()
        if self._host_rows >= self.spill_rows:
            self._activate_spill()

    def _push_device(self, run) -> None:
        level = 0
        while True:
            if level == len(self._dev_levels):
                self._dev_levels.append(run)
                return
            if self._dev_levels[level] is None:
                self._dev_levels[level] = run
                return
            a = self._dev_levels[level]
            self._dev_levels[level] = None
            if self._run_rows(a) + self._run_rows(run) > self.max_device_rows:
                # spill both to the host-side counter
                self._push(self._pull(a))
                self._push(self._pull(run))
                return
            run = self._merge_dev(a, run)
            level += 1

    # the device run's hooks, which ShardedKmerCounter replaces
    @staticmethod
    def _run_rows(run) -> int:
        return run[1].shape[0]

    def _merge_dev(self, a, b):
        return kmer_ops.merge_scattered(a, b)

    def _pull(self, run) -> Tuple[np.ndarray, np.ndarray]:
        return kmer_ops.pull_scattered(*run)

    def add_chunk(self, seqs: np.ndarray, lengths: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> None:
        B, L = seqs.shape
        if L < self.k:
            return
        self._cache_valid = False
        if weights is not None:
            keys, counts = kmer_ops.count_chunk_host(
                seqs, lengths, self.k, np.asarray(weights, np.uint32),
                device=self.device,
            )
        elif self.prefer_host:
            if kmer_ops.num_words(self.k) <= 2:
                keys, counts = kmer_ops.count_chunk_numpy(
                    seqs, lengths, self.k, canonical=self.canonical
                )
            else:
                keys, counts = kmer_ops.count_chunk_host(
                    seqs, lengths, self.k, canonical=self.canonical,
                    device=self.device,
                )
        else:
            self._push_device(kmer_ops.count_chunk_scattered(
                to_device(seqs, self.device), to_device(lengths, self.device),
                self.k, self.canonical,
            ))
            return
        if len(keys):
            self._push((keys, counts))

    def _host_runs(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Pull device levels and collect in-memory host runs (sorted)."""
        dev = None
        for run in self._dev_levels:
            if run is None:
                continue
            dev = run if dev is None else self._merge_dev(dev, run)
        runs = []
        if dev is not None:
            keys, counts = self._pull(dev)
            if len(keys):
                runs.append((keys, counts))
        runs.extend(r for r in self._levels if r is not None)
        return runs

    @staticmethod
    def _fold(runs) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        acc = None
        for keys, counts in runs:
            acc = (keys, counts) if acc is None else kmer_ops.merge_sorted_counts(
                acc[0], acc[1], keys, counts
            )
        return acc

    def merged_iter(self):
        """Yield the merged (keys, counts) table as ascending, disjoint,
        sorted pieces: one without a disk spill, one per key-range bucket
        with one."""
        runs = self._host_runs()
        if self._spill is None:
            acc = self._fold(runs)
            if acc is not None:
                yield acc
            return
        inner = self._spill.inner
        cuts = [
            np.concatenate([[0], np.searchsorted(keys[:, 0], inner), [len(keys)]])
            for keys, _ in runs
        ]
        for b in range(self._spill.n_buckets):
            pieces = self._spill.read_bucket(b)
            for (keys, counts), cut in zip(runs, cuts):
                s, e = int(cut[b]), int(cut[b + 1])
                if e > s:
                    pieces.append((keys[s:e], counts[s:e]))
            acc = self._fold(pieces)
            if acc is not None and len(acc[1]):
                self.peak_host_rows = max(self.peak_host_rows, len(acc[1]))
                yield acc

    def _merged(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self._cache_valid:
            return self._cache
        pieces = list(self.merged_iter())
        if not pieces:
            acc = None
        elif len(pieces) == 1:
            acc = pieces[0]
        else:
            acc = (np.concatenate([p[0] for p in pieces]),
                   np.concatenate([p[1] for p in pieces]))
        self._cache = acc
        self._cache_valid = True
        return acc

    @property
    def keys(self) -> Optional[np.ndarray]:
        m = self._merged()
        return m[0] if m else None

    @property
    def counts(self) -> Optional[np.ndarray]:
        m = self._merged()
        return m[1] if m else None

    def solid(self, min_multi: int) -> Tuple[np.ndarray, np.ndarray]:
        """Gated table, streamed piece by piece."""
        ks, cs = [], []
        for keys, counts in self.merged_iter():
            mask = counts >= min_multi
            if mask.any():
                ks.append(keys[mask])
                cs.append(counts[mask])
        if not ks:
            return (np.zeros((0, kmer_ops.num_words(self.k)), np.uint32),
                    np.zeros(0, np.uint64))
        return np.concatenate(ks), np.concatenate(cs)


class ShardedKmerCounter(KmerCounter):
    """KmerCounter over a ``parallel.mesh.DeviceMesh``: each shard counts
    and LSM-merges its own rows of every chunk on its device
    (count_chunk_scattered_sharded, the sort kernel K4 on a card for
    two-word keys; merge_scattered_sharded, the merge kernel K2; no
    communication a chunk). A run on the device is one scattered run a
    shard, and its size against ``max_device_rows`` is the shards' rows
    summed, as the reference counts its sharded arrays. Extraction
    range-partitions the shards' runs with one all_to_all
    (partition_scattered_sharded), so shard j ends with the exact global
    table of key range j, and joins the shards' tables on the host. The
    host LSM, the disk spill, ``merged_iter`` and ``solid`` are inherited;
    tables equal the single-device counter's byte for byte
    (tests/test_torch_mesh_stages.py). Weighted chunks take the inherited
    exact path on the mesh's first device.

    The shards take the tensor formulations on every device type, as the
    reference's ``shard_map`` bodies are device code on its virtual CPU
    devices."""

    def __init__(self, mesh, k: int, canonical: bool = True, **kw):
        super().__init__(k, canonical=canonical, device=mesh.primary, **kw)
        self.mesh = mesh

    def add_chunk(self, seqs: np.ndarray, lengths: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> None:
        if weights is not None:
            super().add_chunk(seqs, lengths, weights)
            return
        if seqs.shape[1] < self.k:
            return
        self._cache_valid = False
        self._push_device(mesh_mod.count_chunk_scattered_sharded(
            self.mesh, seqs, lengths, self.k, self.canonical))

    @staticmethod
    def _run_rows(run) -> int:
        return sum(counts.shape[0] for _, counts in run)

    def _merge_dev(self, a, b):
        return mesh_mod.merge_scattered_sharded(self.mesh, a, b)

    def _extract(self, run) -> Tuple[np.ndarray, np.ndarray]:
        """all_to_all partition + per-shard merge; the shards' tables in
        order are the global ascending table."""
        parts = mesh_mod.partition_scattered_sharded(self.mesh, run,
                                                     canonical=self.canonical)
        keys = np.concatenate([u32_numpy(w).T for w, _, _ in parts])
        counts = np.concatenate([host(c) for _, c, _ in parts]).astype(np.uint64)
        return np.ascontiguousarray(keys), counts

    def _pull(self, run) -> Tuple[np.ndarray, np.ndarray]:
        return self._extract(run)


def _symmetrize_max(keys: np.ndarray, counts: np.ndarray, kp1: int):
    """Overlay a forward-counted table onto both strands: merge with its
    reverse-complement twin using max (depth overlay semantics)."""
    if len(keys) == 0:
        return keys, counts
    rc = kmer_ops.np_revcomp_keys(keys, kp1)
    order = np.lexsort(tuple(rc[:, w] for w in range(rc.shape[1] - 1, -1, -1)))
    return kmer_ops.merge_sorted_counts(keys, counts, rc[order], counts[order],
                                        op="max")


def count_edges(
    read_source, k: int, min_multi: int, extra_contigs: Sequence[Contig] = (),
    spill_dir: Optional[str] = None, device=None, mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Count SOLID (k+1)-mers over a read source (callable yielding
    (seqs, lengths) numpy chunks) plus re-injected contigs.

    Reads are counted canonically and gated per merged piece
    (palindrome-aware), then expanded to both strands. Contig k-mers are
    overlaid with max(), not summed — the reads they came from are still in
    the stream — and the overlay is strand-symmetrized. With a mesh of more
    than one shard the reads are counted by a ShardedKmerCounter."""
    kp1 = k + 1
    if mesh is not None and mesh.size > 1:
        counter = ShardedKmerCounter(mesh, kp1, spill_dir=spill_dir)
    else:
        counter = KmerCounter(kp1, canonical=True, spill_dir=spill_dir, device=device)
    with trace.span("count.add"):
        for seqs, lengths in read_source():
            trace.count("count.bases", lengths)
            counter.add_chunk(seqs, lengths)
    sk, sc = [], []
    # gate bucket b while a producer thread merges bucket b+1
    with prefetch(counter.merged_iter(), 1, item="count.merge",
                  counters="merge") as gate_src, trace.span("count.gate"):
        for keys, counts in gate_src:
            rc = kmer_ops.np_revcomp_keys(keys, kp1)
            palin = (keys == rc).all(axis=1)
            eff = np.where(palin, counts * 2, counts)
            mask = eff >= min_multi
            if mask.any():
                sk.append(keys[mask])
                sc.append(counts[mask])
        if sk:
            rkeys, rcounts = kmer_ops.expand_canonical(
                np.concatenate(sk), np.concatenate(sc), kp1
            )
        else:
            rkeys = np.zeros((0, kmer_ops.num_words(kp1)), np.uint32)
            rcounts = np.zeros(0, np.uint64)
    if not extra_contigs:
        return rkeys, rcounts
    with trace.span("count.overlay"):
        ccounter = KmerCounter(kp1, device=device)
        for seqs, lengths, weights in _contigs_to_chunks(extra_contigs, kp1):
            ccounter.add_chunk(seqs, lengths, weights)
        ckeys, ccounts = ccounter.solid(min_multi)
        ckeys, ccounts = _symmetrize_max(ckeys, ccounts, kp1)
        return kmer_ops.merge_sorted_counts(rkeys, rcounts, ckeys, ccounts, op="max")


def _contigs_to_chunks(contigs: Sequence[Contig], kp1: int, row_len: int = 4096):
    """Slice contigs into fixed-width rows overlapping by k so no (k+1)-mer
    is lost; each contig's k-mers carry its depth as weight."""
    rows, lens, wts = [], [], []
    step = row_len - kp1 + 1
    for c in contigs:
        codes = encoding.encode(c.seq)
        w = max(1, int(round(c.depth)))
        for s in range(0, max(len(codes) - kp1 + 1, 1), step):
            piece = codes[s : s + row_len]
            if len(piece) < kp1:
                piece = codes[max(0, len(codes) - kp1):]
            row = np.full(row_len, encoding.N, dtype=np.int8)
            row[: len(piece)] = piece
            rows.append(row)
            lens.append(len(piece))
            wts.append(w)
    out = []
    for i in range(0, len(rows), 1024):
        out.append((
            np.stack(rows[i : i + 1024]),
            np.asarray(lens[i : i + 1024], np.int32),
            np.asarray(wts[i : i + 1024], np.uint32),
        ))
    return out


def _mercy_candidates(table: torch.Tensor, ds: torch.Tensor, dl: torch.Tensor,
                      kp1: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Where a read chunk's sub-threshold (k+1)-mers lie between two solid
    ones on the same read: ``(words [W, B, P], mask [B, P])`` a strand."""
    W = table.shape[0]
    out = []
    for ra in (False, True):
        s = kmer_ops.revcomp_codes_padfront(ds) if ra else ds
        words, valid = kmer_ops.extract_kmers(s, dl, kp1, right_aligned=ra)
        member = kmer_ops.multiword_member_sorted(
            table, words.reshape(W, -1)
        ).reshape(valid.shape) & valid
        col = torch.arange(member.shape[1], device=ds.device)
        left = torch.cummax(torch.where(member, col, -1), dim=1).values >= 0
        right = torch.cummax(torch.where(member.flip(1), col, -1),
                             dim=1).values.flip(1) >= 0
        out.append((words, valid & ~member & left & right))
    return out


def add_mercy_edges(
    read_source, keys: np.ndarray, counts: np.ndarray, k: int, device=None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read-path mercy rescue (megahit mercy, only at kmin): a sub-threshold
    (k+1)-mer is kept when some READ carries it between two solid (k+1)-mers.
    Two passes: the reads re-stream against the solid table and only the
    mercy candidates accumulate; a rescued k-mer's count is its number of
    flanked occurrences. With a mesh of more than one shard each chunk's
    rows shard over it, the solid table replicated (the candidates are a
    multiset, so the result is the single-device one)."""
    if len(keys) == 0:
        return keys, counts
    W = keys.shape[1]
    kp1 = k + 1
    if mesh is not None and mesh.size > 1:
        tables = [to_device(np.ascontiguousarray(keys.T), dev) for dev in mesh.devices]

        def candidates(seqs, lengths):
            shards = mesh_mod.shard_batch(mesh, seqs, lengths)
            return [c for t, (ds, dl) in zip(tables, shards)
                    for c in _mercy_candidates(t, ds, dl, kp1)]
    else:
        dev = device_mod.resolve_device(device)
        table = to_device(np.ascontiguousarray(keys.T), dev)

        def candidates(seqs, lengths):
            return _mercy_candidates(table, to_device(seqs, dev),
                                     to_device(lengths, dev), kp1)
    mercy_runs: List[np.ndarray] = []
    for seqs, lengths in read_source():
        for words, mask in candidates(seqs, lengths):
            if bool(mask.any()):
                mercy_runs.append(np.ascontiguousarray(u32_numpy(words[:, mask]).T))
    if not mercy_runs:
        return keys, counts
    cand = np.concatenate(mercy_runs)
    if W <= 2:
        uniq, occ = np.unique(kmer_ops.np_pack64(cand), return_counts=True)
        mkeys = kmer_ops.np_unpack64(uniq, W)
    else:
        uniq_v, occ = np.unique(kmer_ops.np_keys_view(cand), return_counts=True)
        mkeys = uniq_v.view(">u4").reshape(-1, W).astype(np.uint32)
    logger.info(f"mercy: rescued {len(mkeys)} sub-threshold edges via read paths")
    # candidates are disjoint from the solid table by construction
    return kmer_ops.merge_sorted_counts(keys, counts, mkeys, occ.astype(np.uint64))


def _run_graph_pass(keys: np.ndarray, counts: np.ndarray, k: int,
                    device=None, mesh=None) -> dbg_ops.GraphPass:
    E = len(keys)
    if E == 0:
        raise EmptyGraph(f"no solid edges at k={k}")
    if mesh is not None and mesh.size > 1 and (
            mesh.primary.type == "cuda" or os.environ.get("MITOFLEX_MESH_GRAPH") == "1"):
        # the sharded pass (per-card memory O(E / n)) on cards; on the CPU,
        # where its shards share one host, only when forced, as in the
        # reference
        from ..parallel import graph_mesh

        return graph_mesh.graph_unitig_pass_mesh(mesh, keys, counts, k)
    dev = device_mod.resolve_device(device)
    if keys.shape[1] <= 2 and device_mod.uses_host_mirrors(dev):
        return dbg_ops.graph_unitig_pass_host(keys, counts, k)
    # exact sizes: the reference's power-of-two edge capacity only bounded
    # XLA recompiles
    return dbg_ops.graph_unitig_pass(
        to_device(np.ascontiguousarray(keys.T), dev),
        torch.from_numpy(np.minimum(counts, 0xFFFFFFFF).astype(np.int64)).to(dev),
        k,
    )


def assemble_k(
    keys: np.ndarray,
    counts: np.ndarray,
    k: int,
    clean: "graph_clean.CleanParams",
    min_standalone: int = 200,
    max_clean_rounds: int = 8,
    device=None,
    mesh=None,
) -> Tuple[List[Contig], List[Contig]]:
    """One k iteration: graph -> unitigs -> cleaning fixpoint -> contigs.
    Returns (contigs, popped_bubbles); the latter is non-empty only in
    careful_bubble mode and is re-injected at the next k."""
    bubbles: List[Contig] = []
    stale = False  # last pass's unitigs predate a keys/counts filter
    for rnd in range(max_clean_rounds):
        trace.count("graph.rounds")
        with trace.span("graph.pass", round=rnd):
            gp = _run_graph_pass(keys, counts, k, device=device, mesh=mesh)
            n = int(gp.n_nodes)
        if n == 0:
            raise EmptyGraph(f"graph emptied at k={k}")
        with trace.span("graph.unitigs", round=rnd):
            uset = dbg_ops.unitig_set_from_pass(gp, k)
        stale = False
        with trace.span("graph.clean", round=rnd):
            in_deg = host(gp.in_deg)[:n]
            out_deg = host(gp.out_deg)[:n]
            pre = host(gp.prefix_id)[: len(keys)].astype(np.int64)
            suf = host(gp.suffix_id)[: len(keys)].astype(np.int64)
            res = graph_clean.analyze_round(
                uset, in_deg, out_deg, pre, suf, counts, k, clean
            )
            bubbles.extend(Contig(b.seq, b.depth, False) for b in res.bubbles)
            if not res.any:
                break
            keep = ~(res.bad_nodes[np.clip(pre, 0, n - 1)]
                     | res.bad_nodes[np.clip(suf, 0, n - 1)])
            keep &= ~res.bad_edges
            keep &= host(gp.edge_valid)[: len(keys)]
            if keep.all():
                break
            keys, counts = keys[keep], counts[keep]
        stale = True
        if len(keys) == 0:
            raise EmptyGraph(f"graph emptied at k={k}")
    if stale:
        # the fixpoint did not converge: regenerate unitigs from the
        # filtered edge set so killed branches cannot leak into contigs
        with trace.span("graph.pass", round=max_clean_rounds):
            gp = _run_graph_pass(keys, counts, k, device=device, mesh=mesh)
            n = int(gp.n_nodes)
        if n == 0:
            raise EmptyGraph(f"graph emptied at k={k}")
        with trace.span("graph.unitigs", round=max_clean_rounds):
            uset = dbg_ops.unitig_set_from_pass(gp, k)

    with trace.span("graph.unitigs"):
        keep_u = dbg_ops.dedup_strand_mask(uset, k)
        keep_u &= uset.lengths >= min(min_standalone, 2 * k)
        contigs = [
            Contig(uset.seq_str(j), float(uset.depth[j]), bool(uset.circular[j]))
            for j in np.flatnonzero(keep_u)
        ]
    # popped branches arrive once per strand — keep one representative each
    seen: dict = {}
    bubbles = [
        b for b in bubbles
        if seen.setdefault(graph_clean._canonical(b.seq), b) is b
    ]
    return contigs, bubbles


def _consensus_walk(
    v: np.ndarray, min_support: int, consensus_frac: float, max_ext: int
) -> str:
    """Extension string from a [max_ext, 4] vote matrix: grow while a
    clear consensus with enough support exists."""
    total = v.sum(axis=1)
    best = v.max(axis=1)
    ext_len = 0
    for off in range(max_ext):
        if total[off] >= min_support and best[off] >= consensus_frac * total[off]:
            ext_len = off + 1
        else:
            break
    return "".join("ACGT"[int(v[o].argmax())] for o in range(ext_len))


# round 1's candidate reads are kept for later rounds of local_extend while
# they fit this many bytes; past it later rounds re-stream the reads
CAND_BUDGET_BYTES = 256 << 20


def _extend_ends(
    contigs: List[Contig],
    read_source,
    min_support: int,
    consensus_frac: float,
    max_ext: int,
    collect_candidates: bool = False,
    device=None,
    mesh=None,
) -> Tuple[List[Contig], bool,
           Optional[List[Tuple[np.ndarray, np.ndarray]]]]:
    """One extension pass over BOTH contig ends from a single mapping sweep:
    reads overhanging a contig's 3' end vote on the bases beyond it, reads
    overhanging the 5' end (negative unclamped start) on the bases before it
    (in reverse-complement coordinates, so one consensus walk serves both).
    Only 512 bp windows at the contig ends are indexed: a read mapping
    strictly inside never votes. With ``collect_candidates`` the reads a
    later round must re-map are returned as (seqs, lengths) batches, or None
    once their bytes passed CAND_BUDGET_BYTES: collection stops there and
    drops what it had kept."""
    if not contigs:
        return contigs, False, ([] if collect_candidates else None)
    WD = 512
    recs = []
    rec_ci: List[int] = []
    rec_off: List[int] = []
    for j, c in enumerate(contigs):
        if len(c.seq) <= 2 * WD:
            recs.append(fasta.FastaRecord(f"le{j}", c.seq))
            rec_ci.append(j)
            rec_off.append(0)
        else:
            recs.append(fasta.FastaRecord(f"le{j}l", c.seq[:WD]))
            rec_ci.append(j)
            rec_off.append(0)
            recs.append(fasta.FastaRecord(f"le{j}r", c.seq[-WD:]))
            rec_ci.append(j)
            rec_off.append(len(c.seq) - WD)
    rec_ci_a = np.asarray(rec_ci, np.int64)
    rec_off_a = np.asarray(rec_off, np.int64)
    index = mapper_ops.ContigIndex.build(recs, device)
    votes_r = [np.zeros((max_ext, 4), np.int32) for _ in contigs]
    votes_l = [np.zeros((max_ext, 4), np.int32) for _ in contigs]
    clens = np.asarray([len(c.seq) for c in contigs], np.int64)
    candidates: Optional[List[Tuple[np.ndarray, np.ndarray]]] = (
        [] if collect_candidates else None
    )
    cand_bytes = 0
    for seqs, lengths in read_source():
        m = mapper_ops.map_batch(index, seqs, lengths, min_votes=2, mesh=mesh)
        mapped = m.contig >= 0
        ridx = np.maximum(m.contig, 0)
        ci_all = rec_ci_a[ridx]
        start_all = m.raw_pos + rec_off_a[ridx]   # window -> contig coords
        ro_all = np.where(mapped, start_all + lengths - clens[ci_all], 0)
        sel = np.nonzero(mapped & ((ro_all > 0) | (start_all < 0)))[0]
        if candidates is not None:
            # interior placements stay interior in later rounds: re-map only
            # the end-voters and the still-unmapped reads
            keep = ~mapped | (ro_all > 0) | (start_all < 0)
            if keep.any():
                candidates.append((seqs[keep], lengths[keep]))
                cand_bytes += candidates[-1][0].nbytes
                if cand_bytes > CAND_BUDGET_BYTES:
                    candidates = None
        for b in sel:
            ci = int(ci_all[b])
            clen = len(contigs[ci].seq)
            Lr = int(lengths[b])
            if Lr == 0:
                continue
            row = seqs[b, :Lr] if m.strand[b] == 1 else np.asarray(
                encoding.revcomp(seqs[b, :Lr])
            )
            start = int(start_all[b])
            right_over = start + Lr - clen
            if 0 < right_over < Lr:
                over = row[Lr - right_over :][:max_ext]
                ok = over < 4
                np.add.at(votes_r[ci], (np.nonzero(ok)[0], over[ok]), 1)
            left_over = -start
            if 0 < left_over < Lr:
                over = np.asarray(encoding.revcomp(row[:left_over]))[:max_ext]
                ok = over < 4
                np.add.at(votes_l[ci], (np.nonzero(ok)[0], over[ok]), 1)
    changed = False
    out = []
    for ci, c in enumerate(contigs):
        ext_r = _consensus_walk(votes_r[ci], min_support, consensus_frac, max_ext)
        ext_l_rc = _consensus_walk(votes_l[ci], min_support, consensus_frac, max_ext)
        if ext_r or ext_l_rc:
            left = encoding.revcomp_str(ext_l_rc) if ext_l_rc else ""
            out.append(Contig(left + c.seq + ext_r, c.depth, c.circular))
            changed = True
        else:
            out.append(c)
    return out, changed, candidates


def local_extend(
    contigs: List[Contig],
    read_source,
    max_rounds: int = 3,
    min_support: int = 3,
    consensus_frac: float = 0.75,
    max_ext_per_round: int = 60,
    read_stride: int = 1,
    device=None,
    mesh=None,
) -> List[Contig]:
    """Local assembly of contig ends (megahit `local` analog): both ends
    grow from one mapping sweep per round while a clear consensus with
    enough support exists. Rounds after the first re-map only round 1's
    candidate reads (end-voters + unmapped) when they fit
    CAND_BUDGET_BYTES; collection stops as soon as they pass it, and those
    rounds re-stream every read instead."""
    source = read_source
    if read_stride > 1:
        def source():
            for seqs, lengths in read_source():
                yield seqs[::read_stride], lengths[::read_stride]

    cached: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
    for rnd in range(max_rounds):
        if rnd == 0 or cached is None:
            src, collect = source, (rnd == 0)
        else:
            batches = cached

            def src():
                return iter(batches)

            collect = False
        with trace.span("local.round", round=rnd):
            contigs, changed, cand = _extend_ends(
                contigs, src, min_support, consensus_frac,
                max_ext_per_round, collect_candidates=collect, device=device,
                mesh=mesh,
            )
        if cand is not None:
            cached = cand
        if not changed:
            break
    return contigs


def filter_contigs(
    contigs: List[Contig], min_depth: float, min_length: int, max_length: int,
    filter_keep: int = 0,
) -> List[Contig]:
    """Inter-iteration depth/length gate (reference fastfilter semantics)."""
    kept = [
        c for c in contigs
        if c.depth >= min_depth and min_length <= len(c.seq) <= max_length
    ]
    if filter_keep and len(kept) < filter_keep:
        ranked = sorted(contigs, key=lambda c: -c.depth)
        kept = ranked[:filter_keep]
    return kept


@timed()
def assemble(
    cfg: AssembleConfig,
    fastq1: str,
    fastq2: Optional[str],
    out_fasta: str,
    read_chunk: Optional[int] = None,
    max_read_len: int = 256,
    host_shard: Optional[Tuple[int, int]] = None,
    spill_dir: Optional[str] = None,
    device=None,
    mesh=None,
) -> str:
    """Full multi-k assembly from clean FASTQ to contig FASTA on ``device``.

    ``host_shard=(process_id, n_processes)`` restricts this process's read
    ingestion to its record-aligned byte range of each input file; pass
    (0, 1) when the inputs are already per-process files. ``spill_dir``:
    directory for the disk-bucketed host LSM. ``mesh``: a
    ``parallel.mesh.DeviceMesh`` over this process's devices; with more
    than one shard the k-mer counting (ShardedKmerCounter), the mercy pass,
    the read mapping and, on cards, the graph pass run sharded, and the
    contig FASTA is byte-identical to the single-device run's."""
    if read_chunk is None:
        read_chunk = getattr(cfg, "read_chunk", 16384)
    if host_shard is None:
        from ..parallel.distributed import shard_info

        host_shard = shard_info()
    pid, n_hosts = host_shard
    ranges = {}
    if n_hosts > 1:
        from ..parallel import distributed as dist

        for path in (fastq1, fastq2):
            if path and not path.endswith(".gz"):
                ranges[path] = dist.host_file_range(path, pid, n_hosts)
        logger.info(f"assemble: host {pid}/{n_hosts} read ranges {ranges}")

    def read_source():
        # background producer thread: FASTQ decode overlaps device compute;
        # pairing is irrelevant for counting, so the files stream
        # independently
        def chain():
            for path in (fastq1, fastq2):
                if path:
                    yield from fastq.read_batches(
                        path, read_chunk, max_read_len,
                        byte_range=ranges.get(path),
                    )

        with prefetch(chain(), 3) as it:
            for b in it:
                yield b.seqs, b.lengths

    # the k-list is trimmed against the LIBRARY-WIDE max read length, which
    # the kmin counting pass observes (reference assemble.py:79-84)
    seen_max = [0]

    def tracked_source():
        for seqs, lengths in read_source():
            m = int(lengths.max(initial=0))
            if m > seen_max[0]:
                seen_max[0] = m
            yield seqs, lengths

    klist = list(cfg.kmer_list)
    dlist = list(cfg.depth_list or [0] * len(cfg.kmer_list))

    contigs: List[Contig] = []
    bubbles: List[Contig] = []
    last_good: List[Contig] = []
    i = 0
    while i < len(klist):
        k = klist[i]
        with trace.span("assemble.k", k=k):
            source = read_source if i > 0 else tracked_source
            if cfg.prefilter_reads and contigs:
                # later iterations count only reads mapping to surviving contigs
                with trace.span("assemble.prefilter"):
                    recs = [fasta.FastaRecord(f"pf{j}", c.seq) for j, c in enumerate(contigs)]
                    index = mapper_ops.ContigIndex.build(recs, device)

                def source():
                    for seqs, lengths in read_source():
                        with trace.span("assemble.prefilter"):
                            m = mapper_ops.map_batch(index, seqs, lengths, min_votes=2,
                                                     mesh=mesh)
                            keep = m.contig >= 0
                        if keep.any():
                            yield seqs, np.where(keep, lengths, 0).astype(np.int32)

            try:
                # mercy edges only at kmin, like megahit
                mercy_active = (not cfg.no_mercy) and i == 0
                with trace.span("assemble.count"):
                    keys, counts = count_edges(
                        source, k, cfg.min_multi, extra_contigs=contigs + bubbles,
                        spill_dir=spill_dir, device=device, mesh=mesh,
                    )
                if mercy_active:
                    with trace.span("assemble.mercy"):
                        keys, counts = add_mercy_edges(source, keys, counts, k, device=device,
                                                       mesh=mesh)
                trace.count("kmers.solid", len(keys))
                logger.info(f"assemble: k={k}: {len(keys)} solid (k+1)-mers")
                if i == 0 and seen_max[0]:
                    kept = [kk for kk in klist if kk < max(seen_max[0], klist[0] + 1)]
                    if len(kept) < len(klist):
                        logger.info(f"assemble: k-list {klist} -> {kept} "
                                    f"(max read len {seen_max[0]})")
                        klist = kept
                clean = graph_clean.CleanParams(
                    prune_depth=cfg.prune_depth,
                    prune_level=cfg.prune_level,
                    bubble_level=cfg.bubble_level,
                    merge_len=cfg.merge_len,
                    merge_similar=cfg.merge_similar,
                    disconnect_ratio=cfg.disconnect_ratio,
                    low_local_ratio=cfg.low_local_ratio,
                    # reference: careful_bubble = kmer < kmax (wrapper:285)
                    careful_bubble=i < len(klist) - 1,
                )
                with trace.span("assemble.graph"):
                    contigs, bubbles = assemble_k(
                        keys, counts, k, clean, min_standalone=cfg.min_length,
                        device=device, mesh=mesh,
                    )
                with trace.span("assemble.local"):
                    if not cfg.disable_local and any(not c.circular for c in contigs):
                        linear = [c for c in contigs if not c.circular]
                        circular = [c for c in contigs if c.circular]
                        linear = local_extend(linear, source,
                                              read_stride=cfg.local_read_stride,
                                              device=device, mesh=mesh)
                        contigs = circular + linear
            except EmptyGraph as e:
                logger.warn(f"assemble: {e}; stopping multi-k loop at k={k}")
                break
            logger.info(
                f"assemble: k={k}: {len(contigs)} contigs "
                f"(max {max((len(c.seq) for c in contigs), default=0)} bp)"
                + (f", {len(bubbles)} popped bubbles carried" if bubbles else "")
            )
            last_good = contigs
            # min_length gates only the FINAL k (reference assemble.py:97-99)
            final_k = i == len(klist) - 1
            if not cfg.no_filter or final_k:
                depth = dlist[i] if i < len(dlist) else 0
                with trace.span("assemble.gate"):
                    contigs = filter_contigs(
                        contigs, depth, cfg.min_length if final_k else 0,
                        cfg.max_length, cfg.filter_keep,
                    )
                    # bubbles ride the same gate, without the keep fallback
                    bubbles = filter_contigs(bubbles, depth, 0, cfg.max_length)
                logger.info(f"assemble: k={k}: {len(contigs)} contigs after "
                            f"depth>={depth} gate")
                if not contigs:
                    logger.warn("assemble: depth gate removed everything; stopping")
                    contigs = []
                    break
                if final_k:
                    last_good = contigs
            i += 1

    final = filter_contigs(last_good, 0, cfg.min_length, cfg.max_length)
    final_k = klist[min(i, len(klist) - 1)] if klist else 0
    records = [
        fasta.FastaRecord(
            f"k{final_k}_{j}", c.seq,
            {"flag": c.flag, "multi": round(c.depth, 4), "len": len(c.seq)},
        )
        for j, c in enumerate(final)
    ]
    fasta.write_fasta(records, out_fasta)
    logger.info(f"assemble: wrote {len(records)} contigs to {out_fasta}")
    return out_fasta
