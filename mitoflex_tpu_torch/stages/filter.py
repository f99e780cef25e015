"""Filter stage: raw FASTQ -> clean FASTQ.

Port of mitoflex_tpu/stages/filter.py: SE and PE filtering with N-count and
quality-percentage rules, the optional keep-region trim, optional PE dedup
(through the native hash set, native/dedup_native.py) and the
Gbp truncation budget. The host streams fixed-shape batches; the per-base
work runs on the run's device (ops/filter.py: the CUDA filter kernel on a
card), or data-parallel over a device mesh (parallel/mesh.py), whose shards
each filter their rows of every batch.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import FilterConfig
from ..io import fastq
from ..io.prefetch import prefetch
from ..utils import trace
from ..utils.helper import timed
from ..utils.logger import logger

from ..convert import host, to_device, u32_numpy
from ..device import resolve_device
from ..ops import filter as filter_ops
from ..parallel import mesh as mesh_mod


@dataclass
class FilterResult:
    clean1: str
    clean2: Optional[str]
    reads_in: int
    reads_kept: int
    bases_in: int
    bases_kept: int
    duplicates: int

    @property
    def kept_ratio(self) -> float:
        return self.reads_kept / self.reads_in if self.reads_in else 0.0


def _trim_batch(batch: fastq.ReadBatch, keep_region: Tuple[int, int]) -> fastq.ReadBatch:
    """Apply the keep-region window (reference --keep-region BEG,END):
    only bases in [beg, end) are retained."""
    beg, end = keep_region
    if (beg, end) == (0, 0):
        return batch
    L = batch.seqs.shape[1]
    end = end if end > 0 else L
    seqs = np.full_like(batch.seqs, filter_ops.N_CODE)
    quals = np.zeros_like(batch.quals)
    width = max(end - beg, 0)
    seqs[:, :width] = batch.seqs[:, beg:end]
    quals[:, :width] = batch.quals[:, beg:end]
    lengths = np.clip(batch.lengths - beg, 0, width)
    return fastq.ReadBatch(seqs, quals, lengths, batch.count, batch.names)


class _DedupSet:
    """Host u64 dedup set over the (h1, h2) hash pairs (reference
    filter_bin PE dedup via a u64 hash of read 1), on the native
    open-addressing set."""

    def __init__(self) -> None:
        from ..native.dedup_native import NativeDedupSet

        self._set = NativeDedupSet()

    def check_and_add(self, h1: np.ndarray, h2: np.ndarray, active: np.ndarray) -> np.ndarray:
        """True where the read is NOT a duplicate; only ``active`` rows are
        inserted."""
        keys = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
        return self._set.check_and_add(keys, active)


def _apply_budget(keep: np.ndarray, lengths: np.ndarray, used: int, budget: int):
    """Reference truncation semantics (main.rs:255-259): only KEPT read-1
    bases count toward the `--trim` budget, and the record whose length
    pushes the running total PAST the budget is dropped along with
    everything after it. Returns (keep, used, stop)."""
    if not budget:
        return keep, used, False
    cum = used + np.cumsum(np.where(keep, lengths.astype(np.int64), 0))
    over = cum > budget
    if over.any():
        first = int(np.argmax(over))
        keep = keep.copy()
        keep[first:] = False
        return keep, budget, True
    return keep, (int(cum[-1]) if len(cum) else used), False


@timed("filter")
def filter_reads(
    cfg: FilterConfig,
    fastq1: str,
    out1: str,
    fastq2: Optional[str] = None,
    out2: Optional[str] = None,
    host_shard: Optional[Tuple[int, int]] = None,
    device=None,
    mesh=None,
) -> FilterResult:
    """Run the filter stage on ``device``. PE iff fastq2 is given. With
    ``mesh`` the per-batch kernel runs data-parallel across the mesh's
    devices (parallel.mesh.filter_reads_sharded); batches stay host-fed
    either way, and the dedup set and the trimming budget stay global, so
    the output is the single-device run's.

    ``host_shard=(process_id, n_processes)`` makes this process ingest only
    its 1/n slice of the input (record-aligned byte ranges for plain FASTQ,
    batch striding for gzip); None resolves it from parallel.distributed."""
    if host_shard is None:
        from ..parallel.distributed import shard_info

        host_shard = shard_info()
    pid, n_hosts = host_shard
    budget = int(round(cfg.trimming * 1_000_000_000)) if cfg.trimming else 0
    if n_hosts > 1:
        budget //= n_hosts
    dedup = _DedupSet() if (cfg.deduplication and fastq2) else None
    reads_in = reads_kept = bases_in = bases_kept = dups = used = 0
    dev = resolve_device(device)

    if mesh is not None:
        def run_kernel(seqs, quals, lengths, cutoff_lengths):
            return mesh_mod.filter_reads_sharded(
                mesh, seqs, quals, lengths.astype(np.int32),
                cfg.ns_valve, cfg.quality_valve, cfg.percentage_valve,
                cutoff_lengths.astype(np.int32),
            )
    else:
        def run_kernel(seqs, quals, lengths, cutoff_lengths):
            return filter_ops.filter_reads(
                to_device(seqs, dev), to_device(quals, dev),
                to_device(lengths.astype(np.int32), dev),
                cfg.ns_valve, cfg.quality_valve, cfg.percentage_valve,
                to_device(cutoff_lengths.astype(np.int32), dev),
            )

    def _shard_iter(it):
        """Batch striding for unseekable (gz) input: process p keeps
        batches p, p+n, p+2n, ..."""
        if n_hosts <= 1:
            return it
        return itertools.islice(it, pid, None, n_hosts)

    se_range = pe_ranges = None
    if n_hosts > 1 and not fastq1.endswith(".gz") and not (
        fastq2 and fastq2.endswith(".gz")
    ):
        from ..parallel import distributed as dist

        if fastq2 is None:
            se_range = dist.host_file_range(fastq1, pid, n_hosts)
        else:
            pe_ranges = dist.host_pair_ranges(fastq1, fastq2, pid, n_hosts)
        logger.info(f"filter: host {pid}/{n_hosts} ingesting byte range "
                    f"{se_range or pe_ranges}")

    if fastq2 is None:
        se_iter = fastq.read_batches(
            fastq1, cfg.batch_reads, cfg.max_read_len, keep_names=True,
            byte_range=se_range,
        )
        if se_range is None:
            se_iter = _shard_iter(se_iter)
        with fastq.FastqWriter(out1, cfg.compress_output) as w, prefetch(
            se_iter, wait="filter.read_wait"
        ) as batches:
            for batch in batches:
                batch = _trim_batch(batch, cfg.keep_region)
                if cfg.truncate_only:
                    keep = np.ones(batch.capacity, dtype=bool)
                else:
                    with trace.span("filter.device"):
                        keep_d, _, _ = run_kernel(
                            batch.seqs, batch.quals, batch.lengths, batch.lengths
                        )
                        keep = host(keep_d).copy()
                keep[batch.count:] = False
                keep, used, stop = _apply_budget(keep, batch.lengths, used, budget)
                reads_in += batch.count
                bases_in += batch.total_bases
                with trace.span("filter.write"):
                    reads_kept += w.write_batch(batch, keep)
                bases_kept += int(batch.lengths[keep].sum())
                if stop:
                    break
        result = FilterResult(out1, None, reads_in, reads_kept, bases_in, bases_kept, 0)
    else:
        assert out2 is not None
        pe_iter = fastq.read_pair_batches(
            fastq1, fastq2, cfg.batch_reads, cfg.max_read_len, keep_names=True,
            byte_ranges=pe_ranges,
        )
        if pe_ranges is None:
            pe_iter = _shard_iter(pe_iter)
        with fastq.FastqWriter(out1, cfg.compress_output) as w1, fastq.FastqWriter(
            out2, cfg.compress_output
        ) as w2, prefetch(
            pe_iter, wait="filter.read_wait"
        ) as batches:
            for b1, b2 in batches:
                b1 = _trim_batch(b1, cfg.keep_region)
                b2 = _trim_batch(b2, cfg.keep_region)
                if cfg.truncate_only:
                    keep = np.ones(b1.capacity, dtype=bool)
                    keep[b1.count:] = False
                else:
                    with trace.span("filter.device"):
                        # one quality cutoff per pair, from read 1's length
                        # (main.rs:236-241)
                        k1, h1, h2 = run_kernel(b1.seqs, b1.quals, b1.lengths,
                                                b1.lengths)
                        k2, _, _ = run_kernel(b2.seqs, b2.quals, b2.lengths,
                                              b1.lengths)
                        keep = host(k1 & k2).copy()
                    keep[b1.count:] = False
                    if dedup is not None:
                        uniq = dedup.check_and_add(u32_numpy(h1), u32_numpy(h2), keep)
                        dups += int(np.logical_and(keep, ~uniq).sum())
                        keep = np.logical_and(keep, uniq)
                keep, used, stop = _apply_budget(keep, b1.lengths, used, budget)
                reads_in += b1.count
                bases_in += b1.total_bases + b2.total_bases
                with trace.span("filter.write"):
                    reads_kept += w1.write_batch(b1, keep)
                    w2.write_batch(b2, keep)
                bases_kept += int(b1.lengths[keep].sum() + b2.lengths[keep].sum())
                if stop:
                    break
        result = FilterResult(out1, out2, reads_in, reads_kept, bases_in, bases_kept, dups)

    logger.info(
        f"filter: kept {result.reads_kept}/{result.reads_in} read(-pair)s "
        f"({100 * result.kept_ratio:.1f}%), {result.bases_kept}/{result.bases_in} bases"
        + (f", {result.duplicates} duplicates removed" if dedup else "")
    )
    if result.kept_ratio < 0.5 and result.reads_in:
        # reference warns on large size shrink (filter/filter.py:71-72)
        logger.warn("filter: more than half of the reads were discarded — check data quality")
    return result
