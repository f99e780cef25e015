"""Multi-host initialization and sharded ingestion helpers.

Port of mitoflex_tpu/parallel/distributed.py. The devices of one host form
an in-process mesh (parallel/mesh.py); a process group is the multi-host
route, the counterpart of ``jax.distributed``. ``init_distributed`` starts
it, ``shard_info`` reports this process's (rank, world size) from it, else
(0, 1), and the FASTQ byte-range splitters (``host_file_range``,
``host_pair_ranges``) give every process its record-aligned share of an
input file, so ingestion needs no coordination. As in the reference, each
process then filters and assembles its own slice of the reads
(tests/test_torch_distributed.py).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as torch_dist

from ..utils.logger import logger


def init_distributed(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
) -> Tuple[int, int]:
    """Start the default process group from the arguments or the standard
    variables ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
    returns (rank, world size). When neither an address (``init_method``
    or ``MASTER_ADDR``) nor a world size is given, no group is started and
    (0, 1) comes back, the reference's rule. ``backend`` defaults to NCCL
    where a card is visible, each process on the card of its local rank
    (``LOCAL_RANK``, else the rank modulo the card count), and to gloo on
    the CPU."""
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and world_size is None:
        return 0, 1
    if rank is None or world_size is None:
        raise ValueError(f"init_distributed: a process group needs a rank and a world "
                         f"size, got rank {rank}, world size {world_size}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    torch_dist.init_process_group(backend, init_method=init_method or "env://",
                                  rank=rank, world_size=world_size)
    rank, world = torch_dist.get_rank(), torch_dist.get_world_size()
    logger.info(f"distributed: process {rank}/{world} ({backend})")
    return rank, world


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
