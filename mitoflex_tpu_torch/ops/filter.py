"""Read quality filter: the plain PyTorch version and the CUDA kernel.

Port of mitoflex_tpu/ops/filter.py. Per read, within its length: count Ns
(code 4) and "bad" bases (raw phred+33 byte <= ``quality_valve``); keep the
read iff ``n <= ns_valve`` and ``bad < floor(f32(cutoff_len) * f32(pct))``,
where ``cutoff_len`` is mate 1's length for both mates of a pair; and two
uint32 polynomial hashes ``sum((code + 1) * B**i)`` for PE deduplication.

``filter_reads`` launches the hand-written kernel (csrc/filter.cu) on a CUDA
tensor, once, and takes ``filter_reads_ref`` only for a tensor on the CPU.
numpy models of the kernel's regrouped hash sum and of its in-kernel cutoff
are in ``testing/kernel_cases.py``, for the tests. Both
return ``(keep bool [B], h1 [B], h2 [B])`` with the hashes as int32 tensors
holding the uint32 bit patterns (convert.u32_numpy reads them back).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..convert import MASK32, i32_bits

N_CODE = 4
# polynomial hash bases (odd => invertible mod 2^32)
_HASH_B1 = 0x01000193  # FNV prime
_HASH_B2 = 0x85EBCA6B  # murmur3 c2


def _hash_powers(max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """B1**i and B2**i mod 2**32 for i < max_len, as uint32."""
    p1 = np.empty(max_len, dtype=np.uint32)
    p2 = np.empty(max_len, dtype=np.uint32)
    a1 = a2 = 1
    for i in range(max_len):
        p1[i], p2[i] = a1, a2
        a1 = (a1 * _HASH_B1) & MASK32
        a2 = (a2 * _HASH_B2) & MASK32
    return p1, p2


def quality_cutoffs(cutoff_lengths: torch.Tensor, percentage_valve: float) -> torch.Tensor:
    """floor(f32(len) * f32(limit)) as int32 — the reference's
    ``(seq1.len() as f32 * limit) as usize``. The product is taken in float32
    on both sides of the port, so the cutoff is bit-identical. (The limit
    is a CPU scalar tensor, which costs a CUDA operand no copy.)"""
    pct = torch.tensor(percentage_valve, dtype=torch.float32)
    return torch.floor(cutoff_lengths.to(torch.float32) * pct).to(torch.int32)


def filter_reads_ref(
    seqs: torch.Tensor,      # [B, L] int8 base codes
    quals: torch.Tensor,     # [B, L] int8 raw phred+33 bytes
    lengths: torch.Tensor,   # [B] int32
    ns_valve: int,
    quality_valve: int,
    percentage_valve: float,
    cutoff_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the filter kernel."""
    B, L = seqs.shape
    lengths = lengths.to(torch.int64)
    valid = torch.arange(L, device=seqs.device)[None, :] < lengths[:, None]
    n_count = ((seqs == N_CODE) & valid).sum(1)
    bad = ((quals.to(torch.int32) <= quality_valve) & valid).sum(1)
    cutoff = quality_cutoffs(
        lengths if cutoff_lengths is None else cutoff_lengths, percentage_valve
    )
    keep = (n_count <= ns_valve) & (bad < cutoff)
    p1, p2 = _hash_powers(L)
    # int64 accumulate, then the low 32 bits: the uint32 wrap of the kernel
    s = torch.where(valid, seqs.to(torch.int64) + 1, 0)
    h1 = (s * torch.from_numpy(p1.astype(np.int64)).to(seqs.device)).sum(1) & MASK32
    h2 = (s * torch.from_numpy(p2.astype(np.int64)).to(seqs.device)).sum(1) & MASK32
    return keep, i32_bits(h1), i32_bits(h2)


def _bad_arguments(seqs, quals, lengths, cl, dev) -> ValueError:
    """The error for arguments the kernel does not take (built only when
    the wrapper's one combined test has failed)."""
    shape = tuple(seqs.shape)
    for name, t, dtype, want in (
        ("seqs", seqs, torch.int8, shape), ("quals", quals, torch.int8, shape),
        ("lengths", lengths, torch.int32, shape[:1]),
        ("cutoff_lengths", cl, torch.int32, shape[:1]),
    ):
        if t.dtype != dtype or tuple(t.shape) != want or len(want) != t.dim() \
                or t.device != dev or not t.is_contiguous() or seqs.dim() != 2:
            return ValueError(
                f"filter_reads: {name} must be a contiguous {dtype} tensor of "
                f"shape {want if seqs.dim() == 2 else '[B, L]'} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return ValueError("filter_reads: unsupported arguments")


def launch_filter(seqs, quals, lengths, cutoff_lengths, ns_valve: int,
                  quality_valve: int, percentage_valve: float,
                  keep: torch.Tensor, hashes: torch.Tensor) -> None:
    """One launch of the kernel on checked CUDA tensors, writing ``keep``
    [B] bool and ``hashes`` [2, B] int32 (h1, h2). The C launcher takes the
    16-byte-load path where the row width is a multiple of 16 (up to 512)
    and the rows are 16-byte aligned, else the byte-load path."""
    B, L = seqs.shape
    err = kernels.launch(
        seqs.device, kernels.library().mfx_filter_reads,
        seqs.data_ptr(), quals.data_ptr(), lengths.data_ptr(),
        cutoff_lengths.data_ptr(), B, L, ns_valve, quality_valve,
        percentage_valve, keep.data_ptr(), hashes.data_ptr(),
    )
    if err:
        kernels.check(err, "filter_reads")
    filter_reads.launches += 1


def filter_reads(
    seqs: torch.Tensor,
    quals: torch.Tensor,
    lengths: torch.Tensor,
    ns_valve: int,
    quality_valve: int,
    percentage_valve: float,
    cutoff_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The filter on a batch: the CUDA kernel for tensors on a card (one
    launch; the cutoff ``floor(f32(len) * f32(pct))`` is taken inside it),
    the plain version for tensors on the CPU."""
    dev = seqs.device
    if dev.type == "cpu":
        return filter_reads_ref(seqs, quals, lengths, ns_valve, quality_valve,
                                percentage_valve, cutoff_lengths)
    if dev.type != "cuda":
        raise ValueError(f"filter_reads: unsupported device {dev}")
    cl = lengths if cutoff_lengths is None else cutoff_lengths
    i8, i32 = torch.int8, torch.int32
    # one combined test on the hot path; the message is built only on failure
    if not (seqs.dim() == 2 and seqs.dtype is i8 and quals.dtype is i8
            and quals.shape == seqs.shape and lengths.dtype is i32
            and cl.dtype is i32 and lengths.dim() == 1 and cl.dim() == 1
            and lengths.shape[0] == seqs.shape[0] == cl.shape[0]
            and quals.device == dev and lengths.device == dev and cl.device == dev
            and seqs.is_contiguous() and quals.is_contiguous()
            and lengths.is_contiguous() and cl.is_contiguous()):
        raise _bad_arguments(seqs, quals, lengths, cl, dev)
    B = seqs.shape[0]
    keep = torch.empty(B, dtype=torch.bool, device=dev)
    hashes = torch.empty((2, B), dtype=i32, device=dev)
    launch_filter(seqs, quals, lengths, cl, int(ns_valve), int(quality_valve),
                  float(percentage_valve), keep, hashes)
    h1, h2 = hashes.unbind(0)
    return keep, h1, h2


# kernel launches since the last reset (a plain counter, never reset here)
filter_reads.launches = 0
