"""ctypes bindings for the native u64 dedup set (dedup.cpp), with a
pure-Python fallback that keeps identical semantics."""

from __future__ import annotations

import ctypes
from typing import Optional, Set

import numpy as np

from . import fastq_native


class NativeDedupSet:
    def __init__(self, expected: int = 1 << 20):
        self._lib = None
        self._handle = None
        self._py: Optional[Set[int]] = None
        lib = fastq_native._load()
        if lib is not None and hasattr(lib, "mfx_dedup_new"):
            lib.mfx_dedup_new.restype = ctypes.c_void_p
            lib.mfx_dedup_new.argtypes = [ctypes.c_long]
            lib.mfx_dedup_check_add.restype = ctypes.c_long
            lib.mfx_dedup_check_add.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_void_p,
            ]
            lib.mfx_dedup_size.restype = ctypes.c_long
            lib.mfx_dedup_size.argtypes = [ctypes.c_void_p]
            lib.mfx_dedup_free.argtypes = [ctypes.c_void_p]
            self._lib = lib
            self._handle = lib.mfx_dedup_new(expected)
        else:
            self._py = set()

    def check_and_add(self, keys: np.ndarray, active: np.ndarray) -> np.ndarray:
        """keys: [n] uint64; active: [n] bool. Returns bool mask: True where
        the key is NOT a duplicate. Only active rows are inserted."""
        n = len(keys)
        if self._lib is not None:
            keys = np.ascontiguousarray(keys, dtype=np.uint64)
            act = np.ascontiguousarray(active, dtype=np.uint8)
            out = np.empty(n, dtype=np.uint8)
            self._lib.mfx_dedup_check_add(
                self._handle,
                keys.ctypes.data_as(ctypes.c_void_p),
                act.ctypes.data_as(ctypes.c_void_p),
                n,
                out.ctypes.data_as(ctypes.c_void_p),
            )
            return out.astype(bool)
        out = np.ones(n, dtype=bool)
        for i in np.nonzero(active)[0]:
            k = int(keys[i])
            if k in self._py:
                out[i] = False
            else:
                self._py.add(k)
        return out

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.mfx_dedup_size(self._handle))
        return len(self._py)

    def __del__(self):
        if self._lib is not None and self._handle:
            try:
                self._lib.mfx_dedup_free(self._handle)
            except Exception:
                pass
