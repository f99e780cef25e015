"""FASTA reading/writing with the contig-metadata contract.

Replaces the reference's Biopython SeqIO plumbing plus the `flag=/multi=/len=`
description codec (utility/bio/seq.py:28-36). No Biopython dependency: the
formats involved are trivial, and records carry numpy-encoded sequences ready
for device upload.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..utils import seq as seqcodec
from . import encoding


@dataclass
class FastaRecord:
    id: str
    seq: str
    attrs: Dict[str, Union[int, float, str]] = field(default_factory=dict)

    @property
    def codes(self) -> np.ndarray:
        return encoding.encode(self.seq)

    @property
    def flag(self) -> int:
        return int(self.attrs.get("flag", 0) or 0)

    @property
    def multi(self) -> float:
        return float(self.attrs.get("multi", 0.0) or 0.0)

    @property
    def circular(self) -> bool:
        return bool(self.flag & 1)

    def header(self) -> str:
        if self.attrs:
            return seqcodec.compile_seq(self.attrs, self.id)
        return self.id

    def with_attrs(self, **kv) -> "FastaRecord":
        attrs = dict(self.attrs)
        attrs.update(kv)
        attrs["len"] = len(self.seq)
        return FastaRecord(self.id, self.seq, attrs)


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path_or_handle) -> Iterator[FastaRecord]:
    handle = (
        _open(path_or_handle)
        if isinstance(path_or_handle, (str, os.PathLike))
        else path_or_handle
    )
    own = isinstance(path_or_handle, (str, os.PathLike))
    try:
        rec_id, attrs, chunks = None, {}, []
        for line in handle:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if rec_id is not None:
                    yield FastaRecord(rec_id, "".join(chunks), attrs)
                desc = line[1:]
                parsed = seqcodec.decompile(desc)
                rec_id = str(parsed.pop("", desc.split()[0] if desc.split() else ""))
                attrs = parsed
                chunks = []
            elif line:
                chunks.append(line.strip())
        if rec_id is not None:
            yield FastaRecord(rec_id, "".join(chunks), attrs)
    finally:
        if own:
            handle.close()


def write_fasta(records: Sequence[FastaRecord], path: str, width: int = 80) -> str:
    with _open(path, "wt") as f:
        for r in records:
            f.write(f">{r.header()}\n")
            for i in range(0, len(r.seq), width):
                f.write(r.seq[i : i + width] + "\n")
    return path


def load_fasta(path: str) -> List[FastaRecord]:
    return list(read_fasta(path))


# ------------------------------------------------------------------ batching
@dataclass
class ContigBatch:
    """Device-ready batch of contigs: padded code matrix + lengths + depth.

    Padded positions hold code 4 (N) so kernels mask them uniformly.
    """

    ids: List[str]
    codes: np.ndarray    # [n, max_len] int8
    lengths: np.ndarray  # [n] int32
    multi: np.ndarray    # [n] float32
    flags: np.ndarray    # [n] int32

    @classmethod
    def from_records(
        cls, records: Sequence[FastaRecord], max_len: Optional[int] = None, pad_to: int = 128
    ) -> "ContigBatch":
        n = len(records)
        if max_len is None:
            max_len = max((len(r.seq) for r in records), default=pad_to)
        max_len = -(-max_len // pad_to) * pad_to
        codes = np.full((max(n, 1), max_len), encoding.N, dtype=np.int8)
        lengths = np.zeros(max(n, 1), dtype=np.int32)
        multi = np.zeros(max(n, 1), dtype=np.float32)
        flags = np.zeros(max(n, 1), dtype=np.int32)
        for i, r in enumerate(records):
            arr = r.codes[:max_len]
            codes[i, : len(arr)] = arr
            lengths[i] = len(r.seq)
            multi[i] = r.multi
            flags[i] = r.flag
        return cls([r.id for r in records], codes, lengths, multi, flags)
