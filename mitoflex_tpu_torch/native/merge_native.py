"""ctypes binding for the native sorted-run merge (merge.cpp).

``merge_counts`` returns None when the native library is unavailable —
the numpy path in ops/kmer.merge_sorted_counts is the fallback with
identical semantics.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from . import fastq_native

_configured = False


def _lib() -> Optional[ctypes.CDLL]:
    global _configured
    lib = fastq_native._load()
    if lib is None or not hasattr(lib, "mfx_merge_counts"):
        return None
    if not _configured:
        lib.mfx_merge_counts.restype = ctypes.c_long
        lib.mfx_merge_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _configured = True
    return lib


def merge_counts(
    a_keys: np.ndarray, a_counts: np.ndarray,
    b_keys: np.ndarray, b_counts: np.ndarray, op: str,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Merge two sorted (keys [n, W] uint32, counts [n]) runs, combining
    equal keys (op='sum'|'max'). Returns None if the native lib is
    unavailable. Keys must be word-wise big-endian comparable — the same
    order np_keys_view/ merge_sorted_counts use."""
    lib = _lib()
    if lib is None:
        return None
    na, W = a_keys.shape
    nb = b_keys.shape[0]
    ak = np.ascontiguousarray(a_keys, dtype=np.uint32)
    bk = np.ascontiguousarray(b_keys, dtype=np.uint32)
    ac = np.ascontiguousarray(a_counts, dtype=np.uint64)
    bc = np.ascontiguousarray(b_counts, dtype=np.uint64)
    ok = np.empty((na + nb, W), dtype=np.uint32)
    oc = np.empty(na + nb, dtype=np.uint64)
    n = lib.mfx_merge_counts(
        ak.ctypes.data_as(ctypes.c_void_p), ac.ctypes.data_as(ctypes.c_void_p),
        na,
        bk.ctypes.data_as(ctypes.c_void_p), bc.ctypes.data_as(ctypes.c_void_p),
        nb,
        W, 0 if op == "sum" else 1,
        ok.ctypes.data_as(ctypes.c_void_p), oc.ctypes.data_as(ctypes.c_void_p),
    )
    # copies, not views: a view would pin the full (na+nb)-row buffer for
    # as long as the merged run lives (the LSM keeps levels for the whole
    # run — same pinning class as the ReadBatch.shrink fix)
    return ok[:n].copy(), oc[:n].copy()
