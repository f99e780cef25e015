"""Range-partitioned disk spill for sorted (k-mer key, count) runs.

The host side of the k-mer LSM at beyond-RAM scale (the megahit/KMC
discipline — the reference's megahit core counts 5 Gbp inputs in 5-20 GB
by partitioning k-mer buckets to disk, the reference's README.md:19):
each sorted run that would otherwise accumulate in host memory is sliced
into ``n_buckets`` contiguous key ranges and appended to one file per
bucket. Merging then proceeds bucket by bucket: peak host memory is
O(bucket) + the caller's accumulated output (the gated solid table),
never O(distinct k-mers).

Bucket boundaries depend on the key distribution. Both-strand tables are
near-uniform on the leading word (uniform boundaries); CANONICAL tables
(the production count_edges path — KmerCounter(canonical=True)) hold
min(x, rc(x)), whose leading-word fraction u has CDF F(u) = 1-(1-u)^2 =
2u-u^2 — bucket 0 of a uniform split carries ~2x the average load.
``canonical=True`` uses the quantile boundaries of F instead
(boundary_b = (1-sqrt(1-b/B))*2^32) so every bucket holds ~1/B of the
keys.

File format per bucket: repeated records of
``uint64 n | n*W uint32 keys (C order) | n uint64 counts``.
Each record is an ascending sorted run; records merge pairwise with the
native O(n) merge at read time.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
from typing import List, Optional, Tuple

import numpy as np


def canonical_inner_boundaries(n: int) -> np.ndarray:
    """The n-1 inner word0 boundaries equalizing expected load for
    CANONICAL keys: quantiles of F(u) = 2u - u^2 on the leading-word
    fraction, i.e. boundary_j = (1 - sqrt(1 - j/n)) * 2^32."""
    j = np.arange(1, n)
    b = np.floor((1.0 - np.sqrt(1.0 - j / n)) * float(1 << 32))
    return np.minimum(b, float((1 << 32) - 1)).astype(np.uint64).astype(np.uint32)


def uniform_inner_boundaries(n: int) -> np.ndarray:
    return np.asarray([(b * (1 << 32)) // n for b in range(1, n)], np.uint32)


class BucketSpill:
    def __init__(self, W: int, n_buckets: int = 64,
                 base_dir: Optional[str] = None, canonical: bool = False):
        self.W = W
        self.n_buckets = n_buckets
        self.dir = tempfile.mkdtemp(prefix="kmer_spill_", dir=base_dir)
        # inner bucket boundaries on the leading key word: bucket b holds
        # keys with word0 in [inner[b-1], inner[b]); density-matched to
        # the key distribution (canonical vs both-strand, see module doc)
        self.inner = (
            canonical_inner_boundaries(n_buckets) if canonical
            else uniform_inner_boundaries(n_buckets)
        )
        self.rows = 0
        self.bytes_written = 0

    def _path(self, b: int) -> str:
        return os.path.join(self.dir, f"bucket_{b:04d}.bin")

    def append(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Append one ascending sorted run, sliced into bucket ranges."""
        if len(keys) == 0:
            return
        cuts = np.concatenate(
            [[0], np.searchsorted(keys[:, 0], self.inner), [len(keys)]]
        )
        c64 = np.ascontiguousarray(counts.astype(np.uint64))
        k32 = np.ascontiguousarray(keys.astype(np.uint32))
        for b in range(self.n_buckets):
            s, e = int(cuts[b]), int(cuts[b + 1])
            if e <= s:
                continue
            with open(self._path(b), "ab") as f:
                f.write(struct.pack("<Q", e - s))
                f.write(k32[s:e].tobytes())
                f.write(c64[s:e].tobytes())
            self.bytes_written += 8 + (e - s) * (self.W * 4 + 8)
        self.rows += len(keys)

    def read_bucket(self, b: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """All sorted runs appended to bucket b."""
        path = self._path(b)
        if not os.path.exists(path):
            return []
        out = []
        with open(path, "rb") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                (n,) = struct.unpack("<Q", hdr)
                keys = np.frombuffer(f.read(n * self.W * 4), np.uint32)
                keys = keys.reshape(n, self.W)
                counts = np.frombuffer(f.read(n * 8), np.uint64)
                out.append((keys, counts))
        return out

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    def __del__(self):  # best-effort temp cleanup
        try:
            self.cleanup()
        except Exception:
            pass
