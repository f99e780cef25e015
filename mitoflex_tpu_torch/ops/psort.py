"""Sorted-run merges (the k-mer LSM's merge) and lexicographic key sorts.

Port of mitoflex_tpu/ops/psort.py: ``merge_sorted_runs`` (K2),
``merge_sorted_runs_onepass`` (K3) and ``bitonic_sort2`` (K4, here
``sort_words2``). A run is a ``[W, n]`` int32 tensor of key words (uint32
bit patterns, rows sorted in unsigned lexicographic order) plus payload
words that ride with their rows. On CUDA tensors each wrapper launches its
hand-written kernel (csrc/merge.cu, csrc/sort.cu) and takes its plain
version only for tensors on the CPU. Unlike the TPU kernels, any lengths
are accepted (the power-of-two rules were Mosaic constraints). Equal keys
come out with run A's rows first in both versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

_SIGN = -(2**31)  # int32 sign bit: x ^ _SIGN orders signed as x orders unsigned

# Tile sizes of the kernels, mirrored here so that tests and callers can pick
# shapes around them without a built library (the smoke run holds them
# against the library's own mfx_sort_tile_rows / mfx_merge_tile_rows).
SORT_TILE_KEYS = 8192  # keys a block of csrc/sort.cu sorts; runs merge from there


def merge_tile_rows(W: int, P: int) -> int:
    """Output rows per tile of the merge kernels for W key words and P
    payload words (csrc/merge_path.cuh: merge_tile_rows)."""
    row_bytes = 4 * (W + P)
    return 4096 if row_bytes <= 12 else 2048 if row_bytes <= 24 \
        else 1024 if row_bytes <= 48 else 512


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


def _check_words(what: str, name: str, x: torch.Tensor, rows: int,
                 n: Optional[int], dev) -> None:
    if x.dim() != 2 or x.shape[0] != rows or (n is not None and x.shape[1] != n) \
            or x.dtype != torch.int32 or x.device != dev or not x.is_contiguous():
        want = f"[{rows}, {'n' if n is None else n}]"
        raise ValueError(f"{what}: {name} must be a contiguous int32 {want} "
                         f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _cuda_device(what: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")


# --------------------------------------------------------------- K2 merge
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


def merge_sorted_runs(
    a_keys: torch.Tensor, a_vals: torch.Tensor,
    b_keys: torch.Tensor, b_vals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted runs, one payload word each, into one sorted run of
    ``na + nb`` rows."""
    what = "merge_sorted_runs"
    dev = a_keys.device
    if dev.type == "cpu":
        return merge_sorted_runs_ref(a_keys, a_vals, b_keys, b_vals)
    _cuda_device(what, dev)
    W = a_keys.shape[0]
    for name, keys, vals in (("a", a_keys, a_vals), ("b", b_keys, b_vals)):
        _check_words(what, f"{name} keys", keys, W, None, dev)
        if vals.dim() != 1:
            raise ValueError(f"{what}: {name} payload must be a vector, got "
                             f"{tuple(vals.shape)}")
        _check_words(what, f"{name} payload", vals[None], 1, keys.shape[1], dev)
    lib = kernels.library()
    if not 1 <= W <= lib.max_words:
        raise ValueError(f"{what}: {W} key words; the kernel takes 1 to "
                         f"{lib.max_words}")
    na, nb = a_keys.shape[1], b_keys.shape[1]
    n = na + nb
    out_keys = torch.empty((W, n), dtype=torch.int32, device=dev)
    out_vals = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_keys, out_vals
    err = kernels.launch(dev, lib.mfx_merge_sorted_runs,
                  a_keys.data_ptr(), a_vals.data_ptr(), na, b_keys.data_ptr(),
                  b_vals.data_ptr(), nb, W, out_keys.data_ptr(),
                  out_vals.data_ptr())
    kernels.check(err, what)
    merge_sorted_runs.launches += 1
    return out_keys, out_vals


# kernel launches since the last reset (a plain counter, never reset here)
merge_sorted_runs.launches = 0


# ------------------------------------------------------- K3 one-pass merge
def merge_sorted_runs_onepass_ref(
    a_keys: torch.Tensor, a_pays: torch.Tensor,
    b_keys: torch.Tensor, b_pays: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a stable lexicographic sort of the
    concatenation, so equal keys keep A's rows first, as the kernel does."""
    keys = torch.cat([a_keys, b_keys], dim=1)
    pays = torch.cat([a_pays, b_pays], dim=1)
    perm = lexsort_words(keys)
    return keys[:, perm], pays[:, perm]


def merge_sorted_runs_onepass(
    a_keys: torch.Tensor, a_pays: torch.Tensor,
    b_keys: torch.Tensor, b_pays: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted runs in one merge-path pass: ``a_keys`` [W, na] and
    ``b_keys`` [W, nb] key words, ``a_pays`` [P, na] and ``b_pays`` [P, nb]
    payload words (P from 0 to 4). Returns ``(keys [W, na + nb],
    pays [P, na + nb])``, row for row the plain version's output."""
    what = "merge_sorted_runs_onepass"
    dev = a_keys.device
    if dev.type == "cpu":
        return merge_sorted_runs_onepass_ref(a_keys, a_pays, b_keys, b_pays)
    _cuda_device(what, dev)
    W, P = a_keys.shape[0], a_pays.shape[0]
    for name, keys, pays in (("a", a_keys, a_pays), ("b", b_keys, b_pays)):
        _check_words(what, f"{name} keys", keys, W, None, dev)
        _check_words(what, f"{name} payloads", pays, P, keys.shape[1], dev)
    lib = kernels.library()
    if not 1 <= W <= lib.max_words or P > lib.max_payloads:
        raise ValueError(f"{what}: {W} key words and {P} payload words; the "
                         f"kernel takes 1 to {lib.max_words} and 0 to "
                         f"{lib.max_payloads}")
    na, nb = a_keys.shape[1], b_keys.shape[1]
    n = na + nb
    out_keys = torch.empty((W, n), dtype=torch.int32, device=dev)
    out_pays = torch.empty((P, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out_keys, out_pays
    err = kernels.launch(dev, lib.mfx_merge_sorted_runs_onepass,
                  a_keys.data_ptr(), a_pays.data_ptr(), na, b_keys.data_ptr(),
                  b_pays.data_ptr(), nb, W, P, out_keys.data_ptr(),
                  out_pays.data_ptr())
    kernels.check(err, what)
    merge_sorted_runs_onepass.launches += 1
    return out_keys, out_pays


merge_sorted_runs_onepass.launches = 0


# ---------------------------------------------------------- K4 key sort
def sort_words2_ref(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the columns in unsigned lexicographic order."""
    return words[:, lexsort_words(words)]


def sort_words2(words: torch.Tensor) -> torch.Tensor:
    """Sort the columns of ``words`` [2, n] (int32 bit patterns of uint32
    word pairs) in unsigned lexicographic order; returns a new [2, n]
    tensor. Port of the JAX package's ``bitonic_sort2``: keys only, so the
    output is the plain version's, byte for byte. Any n."""
    what = "sort_words2"
    dev = words.device
    if dev.type == "cpu":
        return sort_words2_ref(words)
    _cuda_device(what, dev)
    _check_words(what, "words", words, 2, None, dev)
    lib = kernels.library()
    n = words.shape[1]
    out = torch.empty_like(words)
    if n == 0:
        return out
    scratch = torch.empty_like(words)
    err = kernels.launch(dev, lib.mfx_sort_words2, words.data_ptr(), n,
                  scratch.data_ptr(), out.data_ptr())
    kernels.check(err, what)
    sort_words2.launches += 1
    return out


sort_words2.launches = 0
