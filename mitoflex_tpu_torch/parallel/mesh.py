"""Device mesh and sharded pipeline steps, inside one process.

Port of mitoflex_tpu/parallel/mesh.py. The reference's mesh is one process
over its local devices (``shard_map`` over the axis "data"); so is this
one. A :class:`DeviceMesh` is a tuple of ``torch.device``s along the one
axis "data": shard j's work runs on ``devices[j]``, and the collectives are
copies between the devices of the process:

- ``all_to_all``: for each destination shard, what every source shard cut
  out for it, moved there; split sizes are exact;
- ``all_gather``: the shards' tensors concatenated in shard order, on every
  shard.

(The reference's ``psum`` only summed its bucket-overflow counters, which
are gone, so nothing here needs one.)

Batches stay host-fed, as in the reference: a batch splits into contiguous,
exact row ranges (any row count; a shard may get no rows), each shard runs
the port's single-device function on its rows, on its device (the CUDA
kernels on a card), and the results join in row order on the mesh's first
device, so they equal the single-device call's. The k-mer tables are
range-partitioned by their first key word as in the reference (uniform
boundaries for both-strand tables, ``spill.canonical_inner_boundaries`` for
canonical ones): shard j ends with the exact global table of key range j,
and the shards' tables in order are the global ascending table.

XLA's static shapes forced the reference's fixed bucket capacities (``C``,
``slack``, the power-of-two rounding), their overflow counters and the host
fallbacks behind them. With exact split sizes nothing can overflow, and
none of them exists here: where a reference function returned ``overflow``,
this one returns the rest. Every function launches every shard's work
before it reads anything back to the host, so several cards overlap.
``devices`` may name one card more than once: that runs the sharded code on
a single card, as the reference's tests run it on virtual CPU devices.
Several hosts are several processes, each with its own mesh and its own
byte range of the input (parallel/distributed.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import host, i32_bits, to_device
from ..device import resolve_device
from ..ops import filter as filter_ops
from ..ops import genewise as genewise_ops
from ..ops import kmer as kmer_ops
from ..ops import phmm as phmm_ops
from ..ops import spill
from ..ops import sw as sw_ops
from ..ops.psort import _SIGN

AXIS = "data"


@dataclass(frozen=True)
class DeviceMesh:
    """The shards' devices along the one mesh axis, "data"."""

    devices: Tuple[torch.device, ...]
    axis: str = AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """The device on which the joined results of a sharded call land."""
        return self.devices[0]


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the kernels' launcher needs one)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    shape: Optional[Sequence[int]] = None, axes: Sequence[str] = (AXIS,),
    device=None, devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A mesh of ``prod(shape)`` shards along "data".

    On a card (``device`` a CUDA device, or ``None``: the card) the shards
    are the visible cards ``cuda:0 .. n-1``, all of them when ``shape`` is
    ``None``; a shape that needs more cards than are visible raises, as
    the reference's reshape of ``jax.devices()`` does. On the CPU
    (``device="cpu"``) the shards are ``prod(shape)`` copies of the CPU
    device (one without a shape), the counterpart of the reference tests'
    virtual host devices. ``devices`` names the shards' devices outright
    and may repeat one card, which drives the sharded code on a single
    card."""
    if tuple(axes) != (AXIS,):
        raise ValueError(f"make_mesh: the port's mesh has the one axis {AXIS!r}, "
                         f"not {tuple(axes)}")
    if shape is not None and len(shape) != 1:
        raise ValueError(f"make_mesh: one axis takes a shape of one entry, got "
                         f"{tuple(shape)}")
    n = None if shape is None else int(shape[0])
    if n is not None and n < 1:
        raise ValueError(f"make_mesh: shape {tuple(shape)} has no shard")
    if devices is not None:
        devs = tuple(_indexed(resolve_device(d)) for d in devices)
        if not devs or (n is not None and n != len(devs)):
            raise ValueError(f"make_mesh: {len(devs)} devices for shape {shape}")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"make_mesh: devices of one type only, got {devs}")
        return DeviceMesh(devs)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DeviceMesh((dev,) * (n or 1))
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n > count:
        raise ValueError(f"make_mesh: shape {tuple(shape)} needs {n} cards, but "
                         f"{count} are visible")
    return DeviceMesh(tuple(torch.device("cuda", i) for i in range(n)))


def row_bounds(n_rows: int, n_shards: int) -> List[int]:
    """Cut points of ``n_rows`` rows into ``n_shards`` contiguous ranges
    whose sizes differ by one at most."""
    return [n_rows * j // n_shards for j in range(n_shards + 1)]


def _put(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    return to_device(np.asarray(x), dev)


def shard_batch(mesh: DeviceMesh, *arrays) -> List[tuple]:
    """Shard j's rows of every array (numpy or tensor, rows on axis 0), on
    ``devices[j]``: one tuple a shard. Rows split into contiguous exact
    ranges, so a batch needs no padding to a multiple of the shard count."""
    b = row_bounds(len(arrays[0]), mesh.size)
    return [tuple(_put(a[b[j]:b[j + 1]], dev) for a in arrays)
            for j, dev in enumerate(mesh.devices)]


def all_to_all(mesh: DeviceMesh, blocks: Sequence[Sequence[torch.Tensor]]):
    """``blocks[i][j]`` is what shard i sends shard j, on shard i's device;
    returns ``recv`` with ``recv[j][i]`` that block on shard j's device."""
    n = mesh.size
    return [[blocks[i][j].to(dev, non_blocking=True) for i in range(n)]
            for j, dev in enumerate(mesh.devices)]


def all_gather(mesh: DeviceMesh, tensors: Sequence[torch.Tensor], dim: int = -1):
    """Every shard's tensor concatenated in shard order along ``dim``, on
    every shard's device."""
    return [torch.cat([t.to(dev, non_blocking=True) for t in tensors], dim)
            for dev in mesh.devices]


def exchange(mesh: DeviceMesh, columns: Sequence[Sequence[torch.Tensor]],
             cuts: Sequence[Sequence[int]]):
    """Route rows by exact cuts with one all_to_all a column: the last axis
    of every tensor in ``columns[i]`` holds source i's rows grouped by
    destination, ``cuts[i]`` (n + 1 host ints) the groups' bounds. Returns
    ``recv`` with ``recv[j][i]`` the columns that source i sent shard j
    (contiguous, on shard j's device)."""
    n = mesh.size
    per_col = [all_to_all(mesh, [[col[..., cuts[i][j]:cuts[i][j + 1]].contiguous()
                                  for j in range(n)]
                                 for i, col in enumerate(cols)])
               for cols in zip(*columns)]
    return [[[recv[j][i] for recv in per_col] for i in range(n)] for j in range(n)]


def route_back(mesh: DeviceMesh, answers: Sequence[torch.Tensor],
               recv) -> List[torch.Tensor]:
    """Inverse of :func:`exchange` for one answer a received row:
    ``answers[j]`` holds, along its last axis, the answers to the rows
    shard j received (sources in order, as ``recv[j]`` lists them). Returns
    for each source its answers in the order it sent the rows."""
    n = mesh.size
    back = []
    for j in range(n):
        bounds = np.cumsum([0] + [cols[0].shape[-1] for cols in recv[j]])
        back.append([answers[j][..., bounds[i]:bounds[i + 1]] for i in range(n)])
    got = all_to_all(mesh, back)
    return [torch.cat(got[i], -1) for i in range(n)]


def _range_cuts(first_word: torch.Tensor, inner: np.ndarray) -> torch.Tensor:
    """The n + 1 row bounds of the key ranges of a run sorted by its first
    key word (int32 bits of uint32): range j holds the rows whose first word
    lies in ``[inner[j - 1], inner[j])``. The sign flip makes the signed
    order of the bits the unsigned order of the words."""
    dev = first_word.device
    b = torch.from_numpy(inner.astype(np.uint32).view(np.int32) ^ np.int32(_SIGN)).to(dev)
    m = first_word.shape[0]
    mid = torch.searchsorted((first_word ^ _SIGN).contiguous(), b)
    ends = torch.tensor([0, m], dtype=mid.dtype, device=dev)
    return torch.cat([ends[:1], mid, ends[1:]])


def _inner_boundaries(n: int, canonical: bool) -> np.ndarray:
    """The n - 1 inner first-word boundaries: uniform for both-strand
    tables, density-matched for canonical ones (ops/spill.py)."""
    return (spill.canonical_inner_boundaries(n) if canonical
            else spill.uniform_inner_boundaries(n))


def _merge_tree(runs):
    """Merge scattered runs pairwise, level by level (the merge kernel K2 on
    a card), as the reference merges the runs an all_to_all delivered."""
    while len(runs) > 1:
        nxt = [kmer_ops.merge_scattered(a, b) for a, b in zip(runs[::2], runs[1::2])]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _partition_merge(mesh: DeviceMesh, tables, inner: np.ndarray):
    """Range-partition each shard's sorted unique table ``(words [W, U],
    totals [U] int64)`` by its first key word, route range j of every
    shard to shard j with one all_to_all, and merge there: shard j ends with
    the exact global table of key range j. Returns per shard ``(words [W,
    U_j], totals [U_j] int64, U_j)``.

    The merge carries a count in one 32-bit payload word, so a key's total
    on one shard must stay below 2**32 (the reference's uint32 device
    counts have the same limit); a larger one raises."""
    cuts, wide, cols = [], [], []
    for words, totals in tables:
        cuts.append(_range_cuts(words[0], inner))
        wide.append((totals >> 32).any())
        cols.append([words, i32_bits(totals)])
    if any(bool(w) for w in wide):
        raise ValueError("a k-mer's count on one shard reached 2**32: the "
                         "sharded merge carries counts in 32 bits")
    recv = exchange(mesh, cols, [c.tolist() for c in cuts])
    lazy = []
    for runs in recv:
        words, counts = _merge_tree([tuple(r) for r in runs])
        lazy.append((words, *kmer_ops.scattered_totals(words, counts)))
    return [_compact(w, tot, keep) for w, tot, keep in lazy]


def _compact(words: torch.Tensor, totals: torch.Tensor, keep: torch.Tensor):
    u = words[:, keep]
    return u, totals[keep], u.shape[1]


def _both_strand_kmers(s: torch.Tensor, l: torch.Tensor, k: int):
    """Both strands' k-mers of a read shard: ``(words [W, n], valid [n])``."""
    w_f, v_f = kmer_ops.extract_kmers(s, l, k)
    w_r, v_r = kmer_ops.extract_kmers(kmer_ops.revcomp_codes(s, l), l, k)
    W = w_f.shape[0]
    return (torch.cat([w_f.reshape(W, -1), w_r.reshape(W, -1)], 1),
            torch.cat([v_f.reshape(-1), v_r.reshape(-1)]))


def _local_tables(mesh: DeviceMesh, seqs, lengths, k: int):
    """Each shard's sorted unique both-strand table of its reads:
    ``(words [W, U], counts [U] int64)`` a shard."""
    lazy = [kmer_ops.sort_count_totals(*_both_strand_kmers(s, l, k))
            for s, l in shard_batch(mesh, seqs, lengths)]
    return [_compact(*x)[:2] for x in lazy]


def count_kmers_sharded(mesh: DeviceMesh, seqs, lengths, k: int):
    """Distributed k-mer histogram with a replicated result: each shard
    sort-counts both strands of its reads, an all_gather gives every shard
    every table, and a weighted re-count merges them. Returns one
    ``(words [W, U], counts [U] int64, U)`` a shard, all equal. Per-card
    memory is O(global): :func:`count_kmers_sharded_partitioned` keeps it
    O(global / n)."""
    tables = _local_tables(mesh, seqs, lengths, k)
    gw = all_gather(mesh, [w for w, _ in tables])
    gc = all_gather(mesh, [c for _, c in tables])
    lazy = [kmer_ops.sort_count_totals(w, c > 0, weights=c) for w, c in zip(gw, gc)]
    return [_compact(*x) for x in lazy]


def count_kmers_sharded_partitioned(mesh: DeviceMesh, seqs, lengths, k: int):
    """Distributed k-mer histogram with a PARTITIONED result: each shard
    sort-counts both strands of its reads, range-partitions its table by
    the first key word (uniform boundaries), one all_to_all routes range j
    to shard j, and shard j merges what it received. Returns per shard
    ``(words [W, U_j], counts [U_j] int64, U_j)``; the shards' tables in
    order are the global ascending table."""
    return _partition_merge(mesh, _local_tables(mesh, seqs, lengths, k),
                            _inner_boundaries(mesh.size, False))


# ------------------------------------------------- sharded k-mer LSM steps
def count_chunk_scattered_sharded(mesh: DeviceMesh, seqs, lengths, k: int,
                                  canonical: bool = True):
    """Each shard's scattered run of its rows of a chunk
    (kmer.count_chunk_scattered; the sort kernel K4 on a card when the key
    has two words): a SHARDED scattered run, one ``(words, counts)`` a
    shard, sorted on each shard and unordered across them."""
    return [kmer_ops.count_chunk_scattered(s, l, k, canonical)
            for s, l in shard_batch(mesh, seqs, lengths)]


def merge_scattered_sharded(mesh: DeviceMesh, a, b):
    """Merge two sharded scattered runs shard by shard (the merge kernel K2
    on a card); no communication."""
    return [kmer_ops.merge_scattered(x, y) for x, y in zip(a, b)]


def partition_scattered_sharded(mesh: DeviceMesh, runs, canonical: bool = False):
    """Extract a sharded scattered run: compact each shard's run to its
    sorted unique table, range-partition by key (density-matched
    boundaries for ``canonical`` tables), one all_to_all, merge. Returns
    per shard ``(words [W, U_j], totals [U_j] int64, U_j)``: shard j holds
    the exact global table of key range j, and the shards' tables in order
    are the global ascending table."""
    lazy = [(w, *kmer_ops.scattered_totals(w, c)) for w, c in runs]
    tables = [_compact(*x)[:2] for x in lazy]
    return _partition_merge(mesh, tables, _inner_boundaries(mesh.size, canonical))


# --------------------------------------------------- row-sharded functions
def _replicate(x, dev: torch.device):
    """``x`` on ``dev``: a tensor, or a NamedTuple of tensors and numbers."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if hasattr(x, "_fields"):
        return type(x)(*(_replicate(f, dev) for f in x))
    return x


def _join(mesh: DeviceMesh, outs, dim: int):
    """Per-shard outputs (tensors, or NamedTuples of them) concatenated in
    shard order along ``dim`` on the mesh's first device."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(mesh.primary, non_blocking=True) for o in outs], dim)
    fields = [_join(mesh, [o[f] for o in outs], dim) for f in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def _rows_sharded(mesh: DeviceMesh, fn: Callable, arrays, replicated=(), dim: int = 0):
    """``fn(*shard rows, *replicated)`` on every shard that has rows, on its
    device, joined in row order along output axis ``dim``."""
    outs = []
    for j, (dev, rows) in enumerate(zip(mesh.devices, shard_batch(mesh, *arrays))):
        # an empty batch still runs once, on the last shard's empty rows
        if rows[0].shape[0] or (j == mesh.size - 1 and not outs):
            outs.append(fn(*rows, *(_replicate(r, dev) for r in replicated)))
    return _join(mesh, outs, dim)


def filter_reads_sharded(
    mesh: DeviceMesh, seqs, quals, lengths, ns_valve: int = 10,
    quality_valve: int = 55, percentage_valve: float = 0.2, cutoff_lengths=None,
):
    """Data-parallel read filter: each shard's rows through
    ``ops.filter.filter_reads`` (the kernel K1 on a card); ``(keep, h1,
    h2)`` bit-identical to one call on the whole batch."""
    if cutoff_lengths is None:
        cutoff_lengths = lengths

    def local(s, q, l, c):
        return filter_ops.filter_reads(s, q, l, ns_valve, quality_valve,
                                       percentage_valve, c)

    return _rows_sharded(mesh, local, (seqs, quals, lengths, cutoff_lengths))


def map_reads_sharded(mesh: DeviceMesh, index_keys, contig_of, pos_of, seqs, lengths,
                      min_votes: int = 2, step: int = 4, max_mult: int = 4):
    """Read -> contig mapping fan-out: reads sharded, the (mito-scale) seed
    index replicated on every shard; the tensor mapper ``_map_device`` on
    each shard. Returns ``(contig, pos, strand, votes, raw_pos)``."""
    from ..ops import mapper as mapper_ops  # the mapper imports this module

    def local(s, l, keys, con, pos):
        return mapper_ops._map_device(keys, con, pos, s, l, min_votes, step, max_mult)

    return _rows_sharded(mesh, local, (seqs, lengths), (index_keys, contig_of, pos_of))


def viterbi_scores_multi_sharded(mesh: DeviceMesh, profs, model_lens, seqs, lengths):
    """The nhmmer pass-1 sweep over a mesh: windows sharded, the stacked
    profile bank replicated; ``[M, B]`` scores, bit-identical per window to
    the single-device sweep."""
    def local(s, l, p):
        return phmm_ops.viterbi_scores_multi(p, model_lens, s, l)

    return _rows_sharded(mesh, local, (seqs, lengths), (profs,), dim=1)


def viterbi_scan_sharded(mesh: DeviceMesh, prof, seqs, lengths, model_len: int):
    """The envelope scan over a mesh: profile replicated, windows sharded."""
    def local(s, l, p):
        return phmm_ops.viterbi_scan(p, s, l, model_len)

    return _rows_sharded(mesh, local, (seqs, lengths), (prof,))


def sw_align_sharded(mesh: DeviceMesh, queries, q_lens, targets, t_lens, submat,
                     gap_open: float = 11.0, gap_extend: float = 1.0):
    """Smith-Waterman fan-out: (query, target) pairs sharded, the
    substitution matrix replicated; ``SwHits`` of the whole batch."""
    sub = torch.as_tensor(np.asarray(submat), dtype=torch.float32)

    def local(q, ql, t, tl, sm):
        return sw_ops.sw_align(q, ql, t, tl, sm, gap_open, gap_extend)

    return _rows_sharded(mesh, local, (queries, q_lens, targets, t_lens), (sub,))


def genewise_align_sharded(mesh: DeviceMesh, queries, q_lens, target_aa, t_lens, submat,
                           gap_open: float = 13.0, gap_extend: float = 3.0,
                           fs_penalty: float = 15.0, stop_penalty: float = 20.0):
    """Genewise windows sharded over the mesh (the reference refines hits
    serially through wise2); ``WiseHits`` of the whole batch."""
    sub = torch.as_tensor(np.asarray(submat), dtype=torch.float32)

    def local(q, ql, t, tl, sm):
        return genewise_ops.genewise_align(q, ql, t, tl, sm, gap_open, gap_extend,
                                           fs_penalty, stop_penalty)

    return _rows_sharded(mesh, local, (queries, q_lens, target_aa, t_lens), (sub,))


def pipeline_step(mesh: DeviceMesh, seqs, quals, lengths, prof, model_len: int,
                  k: int = 21) -> dict:
    """One device step of the pipeline over a mesh: filter -> partitioned
    k-mer merge (all_to_all) -> profile scan; the unit a dry run drives.
    Inputs are numpy arrays; returns host numbers."""
    keep, _, _ = filter_reads_sharded(mesh, seqs, quals, lengths)
    lengths_f = np.where(host(keep), np.asarray(lengths), 0).astype(np.int32)
    tables = count_kmers_sharded_partitioned(mesh, seqs, lengths_f, k)
    hits = viterbi_scan_sharded(mesh, prof, seqs, lengths_f, model_len)
    return dict(
        kept=int(host(keep).sum()),
        n_unique_kmers=sum(n for _, _, n in tables),
        max_count=max((int(c.max()) for _, c, n in tables if n), default=0),
        best_score=float(hits.score.max()),
    )
