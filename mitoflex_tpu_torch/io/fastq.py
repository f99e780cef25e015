"""FASTQ ingestion: stream 4-line records into device-ready batches.

This is the host side of the filter stage — the role the reference delegates
to its Rust stream filter's I/O layer (filter/filter_bin/src/helper.rs:14-51:
gz or plain, 4-line records). Here the host only parses and packs; all
per-base decisions run on device (ops/filter.py).

Batches are fixed-shape (batch_reads × max_read_len int8) so the device
kernel compiles once; ragged tails are padded and masked by length. A
native C++ parser (native/) is used when built, with this pure-Python
implementation as fallback — same record semantics.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import encoding

PHRED_OFFSET = 33


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


@dataclass
class ReadBatch:
    """A fixed-shape batch of reads.

    seqs:  [n, L] int8 base codes (pad = 4)
    quals: [n, L] int8 raw phred+33 byte values (pad = 0)
    lengths: [n] int32
    count: number of valid rows (<= n)
    names: optional read names (kept only when writing back FASTQ)
    """

    seqs: np.ndarray
    quals: np.ndarray
    lengths: np.ndarray
    count: int
    names: Optional[List[bytes]] = None

    @property
    def capacity(self) -> int:
        return self.seqs.shape[0]

    @property
    def total_bases(self) -> int:
        return int(self.lengths[: self.count].sum())

    def shrink(self, floor: int = 256) -> "ReadBatch":
        """Right-size a partial batch: slice the row axis down to the
        power-of-two bucket holding ``count`` (>= floor). Tail batches of a
        stream otherwise run every downstream device kernel (filter, k-mer
        count, mapper joins) at full chunk width — on small inputs that is
        2-4x wasted compute. Pow2 bucketing keeps the set of compiled
        shapes logarithmic; a full batch returns itself unchanged."""
        cap = self.capacity
        m = floor
        while m < self.count:
            m <<= 1
        if m >= cap:
            return self
        # Copy the slices: numpy views would pin the full-capacity buffers
        # (~16 MB/batch at defaults) alive for as long as the shrunk batch
        # is referenced, and prefetch pipelines hold several batches.
        return ReadBatch(
            self.seqs[:m].copy(), self.quals[:m].copy(),
            self.lengths[:m].copy(), self.count, self.names,
        )


class FastqStream:
    """Iterate a FASTQ file (gz or plain) as raw (name, seq, qual) byte
    triples. Separator line ('+') content is discarded, like the
    reference's reader."""

    def __init__(self, path: str, byte_range: Optional[Tuple[int, int]] = None):
        if byte_range is not None and path.endswith(".gz"):
            raise ValueError("byte_range requires an uncompressed FASTQ")
        self.path = path
        self.byte_range = byte_range

    def __iter__(self) -> Iterator[Tuple[bytes, bytes, bytes]]:
        start, end = self.byte_range or (0, None)
        with _open_text(self.path) as f:
            if start:
                f.seek(start)
            while True:
                if end is not None and f.tell() >= end:
                    return
                name = f.readline()
                if not name:
                    return
                seq = f.readline().rstrip()
                f.readline()  # '+'
                qual = f.readline().rstrip()
                yield name.rstrip(), seq, qual


def _try_native_batches(path, batch_reads, max_read_len, keep_names, limit_bases):
    """Use the C++ reader when its shared library is available."""
    try:
        from ..native import fastq_native

        # the C++ reader handles plain and gzip input but does not retain
        # read names (writers synthesize them), so it only serves the
        # name-free consumers (assembly, mapping)
        if fastq_native.available() and not keep_names:
            return fastq_native.read_batches(path, batch_reads, max_read_len, limit_bases)
    except Exception:
        pass
    return None


def read_batches(
    path: str,
    batch_reads: int = 65536,
    max_read_len: int = 256,
    keep_names: bool = False,
    limit_bases: int = 0,
    byte_range: "Optional[Tuple[int, int]]" = None,
) -> Iterator[ReadBatch]:
    """Yield fixed-shape batches. ``limit_bases`` truncates the stream after
    N bases total (the reference's ``trimming`` Gbp gate,
    filter/filter_bin/src/main.rs: stop after `trim` bp). ``byte_range``
    restricts the stream to a record-aligned file slice — the multi-host
    sharded-ingestion contract (parallel/distributed.host_file_range)."""
    if byte_range is None:
        native = _try_native_batches(path, batch_reads, max_read_len, keep_names, limit_bases)
        if native is not None:
            for b in native:
                yield b.shrink()
            return
    seqs = np.full((batch_reads, max_read_len), encoding.N, dtype=np.int8)
    quals = np.zeros((batch_reads, max_read_len), dtype=np.int8)
    lengths = np.zeros(batch_reads, dtype=np.int32)
    names: List[bytes] = []
    i = 0
    seen = 0
    for name, seq, qual in FastqStream(path, byte_range):
        if limit_bases and seen >= limit_bases:
            break
        L = min(len(seq), max_read_len)
        seqs[i, :L] = encoding.encode(seq[:L])
        quals[i, :L] = np.frombuffer(qual[:L], dtype=np.uint8).astype(np.int8)
        lengths[i] = L
        if keep_names:
            names.append(name)
        seen += L
        i += 1
        if i == batch_reads:
            yield ReadBatch(seqs, quals, lengths, i, names if keep_names else None)
            seqs = np.full((batch_reads, max_read_len), encoding.N, dtype=np.int8)
            quals = np.zeros((batch_reads, max_read_len), dtype=np.int8)
            lengths = np.zeros(batch_reads, dtype=np.int32)
            names = []
            i = 0
    if i:
        yield ReadBatch(seqs, quals, lengths, i, names if keep_names else None).shrink()


def read_pair_batches(
    path1: str,
    path2: str,
    batch_reads: int = 65536,
    max_read_len: int = 256,
    keep_names: bool = False,
    limit_bases: int = 0,
    byte_ranges: "Optional[Tuple[Tuple[int, int], Tuple[int, int]]]" = None,
) -> Iterator[Tuple[ReadBatch, ReadBatch]]:
    """Paired-end batches: records are consumed in lockstep; a pair counts
    toward the base limit with both mates. ``byte_ranges`` restricts each
    file to a PAIR-ALIGNED slice (both ranges must start at the same record
    index — parallel/distributed.host_pair_ranges guarantees it by matching
    read names)."""
    r1, r2 = byte_ranges if byte_ranges is not None else (None, None)
    it1 = FastqStream(path1, r1).__iter__()
    it2 = FastqStream(path2, r2).__iter__()

    def fresh():
        return (
            np.full((batch_reads, max_read_len), encoding.N, dtype=np.int8),
            np.zeros((batch_reads, max_read_len), dtype=np.int8),
            np.zeros(batch_reads, dtype=np.int32),
            [],
        )

    s1, q1, l1, n1 = fresh()
    s2, q2, l2, n2 = fresh()
    i = 0
    seen = 0
    while True:
        if limit_bases and seen >= limit_bases:
            break
        try:
            name1, seq1, qual1 = next(it1)
            name2, seq2, qual2 = next(it2)
        except StopIteration:
            break
        for (seqs, quals, lengths, names, name, seq, qual) in (
            (s1, q1, l1, n1, name1, seq1, qual1),
            (s2, q2, l2, n2, name2, seq2, qual2),
        ):
            L = min(len(seq), max_read_len)
            seqs[i, :L] = encoding.encode(seq[:L])
            quals[i, :L] = np.frombuffer(qual[:L], dtype=np.uint8).astype(np.int8)
            lengths[i] = L
            if keep_names:
                names.append(name)
            seen += L
        i += 1
        if i == batch_reads:
            yield (
                ReadBatch(s1, q1, l1, i, n1 if keep_names else None),
                ReadBatch(s2, q2, l2, i, n2 if keep_names else None),
            )
            s1, q1, l1, n1 = fresh()
            s2, q2, l2, n2 = fresh()
            i = 0
    if i:
        yield (
            ReadBatch(s1, q1, l1, i, n1 if keep_names else None).shrink(),
            ReadBatch(s2, q2, l2, i, n2 if keep_names else None).shrink(),
        )


class FastqWriter:
    """Write filtered reads back out (plain or gzip)."""

    def __init__(self, path: str, compress: bool = False):
        if compress and not path.endswith(".gz"):
            path += ".gz"
        self.path = path
        self._f = gzip.open(path, "wb") if path.endswith(".gz") else open(path, "wb")
        self._n = 0

    def write_batch(self, batch: ReadBatch, keep_mask: np.ndarray) -> int:
        """Write rows of ``batch`` where ``keep_mask`` is true; synthesizes
        ``@r{i}`` names when the batch carries none."""
        written = 0
        decode_lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
        for row in np.nonzero(keep_mask[: batch.count])[0]:
            L = int(batch.lengths[row])
            seq = decode_lut[np.clip(batch.seqs[row, :L], 0, 4)].tobytes()
            qual = batch.quals[row, :L].astype(np.uint8).tobytes()
            if batch.names is not None:
                name = batch.names[row]
                if not name.startswith(b"@"):
                    name = b"@" + name
            else:
                name = b"@r%d" % (self._n + written)
            self._f.write(name + b"\n" + seq + b"\n+\n" + qual + b"\n")
            written += 1
        self._n += written
        return written

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
