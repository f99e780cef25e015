"""Read quality filter: the plain PyTorch version and the CUDA kernel.

Port of mitoflex_tpu/ops/filter.py. Per read, within its length: count Ns
(code 4) and "bad" bases (raw phred+33 byte <= ``quality_valve``); keep the
read iff ``n <= ns_valve`` and ``bad < floor(f32(cutoff_len) * f32(pct))``,
where ``cutoff_len`` is mate 1's length for both mates of a pair; and two
uint32 polynomial hashes ``sum((code + 1) * B**i)`` for PE deduplication.

``filter_reads`` launches the hand-written kernel (csrc/filter.cu) on a CUDA
tensor and takes ``filter_reads_ref`` only for a tensor on the CPU. Both
return ``(keep bool [B], h1 [B], h2 [B])`` with the hashes as int32 tensors
holding the uint32 bit patterns (convert.u32_numpy reads them back).
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=8)
def _device_powers(L: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash power tables on a card, built once per row width."""
    p1, p2 = _hash_powers(L)
    return (torch.from_numpy(p1.view(np.int32)).to(device),
            torch.from_numpy(p2.view(np.int32)).to(device))


def filter_reads(
    seqs: torch.Tensor,
    quals: torch.Tensor,
    lengths: torch.Tensor,
    ns_valve: int,
    quality_valve: int,
    percentage_valve: float,
    cutoff_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The filter on a batch: the CUDA kernel for tensors on a card, the
    plain version for tensors on the CPU."""
    dev = seqs.device
    if dev.type == "cpu":
        return filter_reads_ref(seqs, quals, lengths, ns_valve, quality_valve,
                                percentage_valve, cutoff_lengths)
    if dev.type != "cuda":
        raise ValueError(f"filter_reads: unsupported device {dev}")
    B, L = seqs.shape
    cl = lengths if cutoff_lengths is None else cutoff_lengths
    for name, t, dtype, shape in (
        ("seqs", seqs, torch.int8, (B, L)), ("quals", quals, torch.int8, (B, L)),
        ("lengths", lengths, torch.int32, (B,)),
        ("cutoff_lengths", cl, torch.int32, (B,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"filter_reads: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    cutoffs = quality_cutoffs(cl, percentage_valve)
    p1, p2 = _device_powers(L, dev)
    keep = torch.empty(B, dtype=torch.bool, device=dev)
    h1 = torch.empty(B, dtype=torch.int32, device=dev)
    h2 = torch.empty(B, dtype=torch.int32, device=dev)
    err = kernels.launch(
        dev, kernels.library().mfx_filter_reads,
        seqs.data_ptr(), quals.data_ptr(), lengths.data_ptr(),
        cutoffs.data_ptr(), p1.data_ptr(), p2.data_ptr(), B, L,
        int(ns_valve), int(quality_valve), keep.data_ptr(), h1.data_ptr(),
        h2.data_ptr(),
    )
    kernels.check(err, "filter_reads")
    filter_reads.launches += 1
    return keep, h1, h2


# kernel launches since the last reset (a plain counter, never reset here)
filter_reads.launches = 0
