"""Sorted-run merge (the k-mer LSM's merge) and lexicographic key sorts.

Port of mitoflex_tpu/ops/psort.py ``merge_sorted_runs``. A run is a
``[W, n]`` int32 tensor of key words (uint32 bit patterns, rows sorted in
unsigned lexicographic order) plus one ``[n]`` int32 payload column.
``merge_sorted_runs`` launches the hand-written merge-path kernel
(csrc/merge.cu) on CUDA tensors and takes ``merge_sorted_runs_ref`` only for
tensors on the CPU. Unlike the TPU kernel's bitonic network, any run
lengths are accepted (the power-of-two rule was a Mosaic constraint).
Equal keys come out with run A's rows first in both versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

_SIGN = -(2**31)  # int32 sign bit: x ^ _SIGN orders signed as x orders unsigned


def _pair_key(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """One int64 sort key whose signed order is the unsigned lexicographic
    order of the word pair (hi, lo): the sign-flipped high word times 2**32
    plus the low word's unsigned value."""
    k = (hi ^ _SIGN).to(torch.int64)
    if lo is None:
        return k
    return k * 2**32 + (lo.to(torch.int64) & 0xFFFFFFFF)


def lexsort_words(words: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting the columns of ``words`` [W, n] (int32 bit
    patterns of uint32) in unsigned lexicographic order.

    ``torch.sort`` takes one key, so the words pack pairwise into int64 keys
    and stable passes run from the least significant pair to the most
    (W = 8 on the golden k-list takes four passes)."""
    W, n = words.shape
    perm: Optional[torch.Tensor] = None
    for lo in reversed(range(0, W, 2)):
        key = _pair_key(words[lo], words[lo + 1] if lo + 1 < W else None)
        if perm is not None:
            key = key[perm]
        idx = torch.sort(key, stable=True).indices
        perm = idx if perm is None else perm[idx]
    if perm is None:
        perm = torch.arange(n, device=words.device)
    return perm


def merge_sorted_runs_ref(
    a_keys: torch.Tensor, a_vals: torch.Tensor,
    b_keys: torch.Tensor, b_vals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a stable lexicographic sort of the
    concatenation (so equal keys keep A's rows first, as the kernel does)."""
    keys = torch.cat([a_keys, b_keys], dim=1)
    vals = torch.cat([a_vals, b_vals])
    perm = lexsort_words(keys)
    return keys[:, perm], vals[perm]


def _check_run(name: str, keys: torch.Tensor, vals: torch.Tensor, W: int, dev):
    if keys.dim() != 2 or keys.shape[0] != W or keys.dtype != torch.int32 \
            or keys.device != dev or not keys.is_contiguous():
        raise ValueError(f"merge_sorted_runs: {name} keys must be a contiguous "
                         f"int32 [{W}, n] tensor on {dev}, got {keys.dtype} "
                         f"{tuple(keys.shape)} on {keys.device}")
    if vals.shape != (keys.shape[1],) or vals.dtype != torch.int32 \
            or vals.device != dev or not vals.is_contiguous():
        raise ValueError(f"merge_sorted_runs: {name} payload must be a "
                         f"contiguous int32 [{keys.shape[1]}] tensor on {dev}")


def merge_sorted_runs(
    a_keys: torch.Tensor, a_vals: torch.Tensor,
    b_keys: torch.Tensor, b_vals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted runs into one sorted run of ``na + nb`` rows."""
    dev = a_keys.device
    if dev.type == "cpu":
        return merge_sorted_runs_ref(a_keys, a_vals, b_keys, b_vals)
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted_runs: unsupported device {dev}")
    W = a_keys.shape[0]
    _check_run("a", a_keys, a_vals, W, dev)
    _check_run("b", b_keys, b_vals, W, dev)
    lib = kernels.library()
    if W > lib.mfx_merge_max_words():
        raise ValueError(f"merge_sorted_runs: {W} key words exceed the "
                         f"kernel's {lib.mfx_merge_max_words()}")
    na, nb = a_keys.shape[1], b_keys.shape[1]
    n = na + nb
    out_keys = torch.empty((W, n), dtype=torch.int32, device=dev)
    out_vals = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_keys, out_vals
    tile = lib.mfx_merge_tile_rows()
    split = torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mfx_merge_sorted_runs(
            a_keys.data_ptr(), a_vals.data_ptr(), na, b_keys.data_ptr(),
            b_vals.data_ptr(), nb, W, split.data_ptr(), out_keys.data_ptr(),
            out_vals.data_ptr(), stream,
        )
    kernels.check(err, "merge_sorted_runs")
    merge_sorted_runs.launches += 1
    return out_keys, out_vals


# kernel launches since the last reset (a plain counter, never reset here)
merge_sorted_runs.launches = 0
