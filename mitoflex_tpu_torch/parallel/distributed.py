"""Process sharding for the port.

``shard_info`` reports this process's (rank, world size) from
``torch.distributed`` when a process group is up, else (0, 1). The FASTQ
byte-range splitters (``host_file_range``, ``host_pair_ranges``) give every
process its record-aligned share of an input file. Multi-device and
multi-process runs of the stages are not ported yet (ROADMAP).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch.distributed as torch_dist


def shard_info() -> Tuple[int, int]:
    """(process rank, process count); (0, 1) for a single process."""
    if torch_dist.is_available() and torch_dist.is_initialized():
        return torch_dist.get_rank(), torch_dist.get_world_size()
    return 0, 1


def _align_to_record(f, raw: int, size: int) -> int:
    """First byte at/after ``raw`` that starts a FASTQ record: an '@' line
    whose line+2 is the '+' separator (quality lines may also start with
    '@', so the shape check is required)."""
    if raw <= 0:
        return 0
    if raw >= size:
        return size
    f.seek(raw)
    f.readline()  # skip the partial line
    while True:
        pos = f.tell()
        line = f.readline()
        if not line:
            return size
        if line.startswith(b"@"):
            f.readline()
            sep = f.readline()
            f.seek(pos)
            if sep.startswith(b"+"):
                return pos
            f.readline()


def _base_name(name: bytes) -> bytes:
    """Pair-invariant read name: first token, '@' and mate suffix
    ('/1'/'/2') stripped."""
    parts = name.split()
    tok = parts[0] if parts else name
    tok = tok.lstrip(b"@")
    if len(tok) > 2 and tok[-2:-1] == b"/" and tok[-1:] in (b"1", b"2"):
        tok = tok[:-2]
    return tok


def host_pair_ranges(
    path1: str, path2: str, process_id: int, n_processes: int
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Pair-aligned per-host byte ranges of a PE FASTQ pair.

    File 1 is split like host_file_range; each file-1 boundary is then
    located in file 2 by READ NAME: seek to the proportional offset backed
    off by a margin, align to a record, and scan forward until the mate of
    the boundary record is found (mates appear in the same order in both
    files, and byte offsets drift only by name/length differences, so the
    scan is short). Guarantees both ranges start at the same record index —
    the contract read_pair_batches(byte_ranges=...) requires."""
    size1 = os.path.getsize(path1)
    size2 = os.path.getsize(path2)
    with open(path1, "rb") as f1, open(path2, "rb") as f2:
        b1 = [0]
        for j in range(1, n_processes):
            b1.append(_align_to_record(f1, size1 * j // n_processes, size1))
        b1.append(size1)

        b2 = [0]
        for j in range(1, n_processes):
            pos1 = b1[j]
            if pos1 >= size1:
                b2.append(size2)
                continue
            f1.seek(pos1)
            target = _base_name(f1.readline().rstrip())
            found = None
            for margin in (1 << 16, 1 << 22, 1 << 26, size2):
                guess = max(0, size2 * j // n_processes - margin)
                pos2 = _align_to_record(f2, guess, size2)
                f2.seek(pos2)
                budget = margin + (1 << 22)
                while f2.tell() - pos2 < budget:
                    rec_start = f2.tell()
                    name = f2.readline()
                    if not name:
                        break
                    f2.readline()
                    f2.readline()
                    f2.readline()
                    if _base_name(name.rstrip()) == target:
                        found = rec_start
                        break
                if found is not None:
                    break
            if found is None:
                raise RuntimeError(
                    f"host_pair_ranges: mate of {target!r} not found in "
                    f"{path2} near boundary {j}/{n_processes} — are the "
                    "files a matched pair?"
                )
            b2.append(found)
        b2.append(size2)
    return (
        (b1[process_id], b1[process_id + 1]),
        (b2[process_id], b2[process_id + 1]),
    )


def host_file_range(path: str, process_id: int, n_processes: int) -> Tuple[int, int]:
    """Deterministic per-host byte range of a FASTQ file: the raw equal
    shares are aligned forward to record starts, and each host's end IS the
    next host's aligned start — contiguous, non-overlapping, covering."""
    size = os.path.getsize(path)
    share = size // n_processes
    with open(path, "rb") as f:
        start = _align_to_record(f, share * process_id, size)
        end = size if process_id == n_processes - 1 else _align_to_record(
            f, share * (process_id + 1), size
        )
    return start, end
