"""ctypes binding for the native de Bruijn graph + unitig pass (graph.cpp).

``graph_pass`` returns None when the native library is unavailable — the
numpy formulation in ops/dbg.graph_unitig_pass_host is the fallback with
identical output (parity-tested in tests/test_native.py)."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from . import fastq_native

_configured = False


def _lib() -> Optional[ctypes.CDLL]:
    global _configured
    lib = fastq_native._load()
    if lib is None or not hasattr(lib, "mfx_graph_pass"):
        return None
    if not _configured:
        lib.mfx_graph_pass.restype = ctypes.c_long
        lib.mfx_graph_pass.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ] + [ctypes.c_void_p] * 10
        _configured = True
    return lib


def graph_pass(keys: np.ndarray, counts: np.ndarray, k: int) -> Optional[Tuple]:
    """Run the native graph+unitig pass on a sorted both-strand edge table.

    keys: [E, W] uint32 (W <= 2), counts: [E]. Returns
    (node_words [V, W], V, out_deg, in_deg, root, offset, link_count,
    is_cycle, prefix_id, suffix_id, order) — the GraphPass fields plus the
    chain order (argsort by (root, offset)), or None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    E, W = keys.shape
    if E == 0 or W > 2 or k > 31:
        return None
    ks = np.ascontiguousarray(keys, dtype=np.uint32)
    cs = np.ascontiguousarray(counts, dtype=np.uint64)
    Vcap = 2 * E
    node_words = np.empty((Vcap, W), np.uint32)
    out_deg = np.empty(Vcap, np.int32)
    in_deg = np.empty(Vcap, np.int32)
    root = np.empty(Vcap, np.int32)
    offset = np.empty(Vcap, np.int32)
    link_count = np.empty(Vcap, np.uint32)
    is_cycle = np.empty(Vcap, np.uint8)
    prefix_id = np.empty(E, np.int32)
    suffix_id = np.empty(E, np.int32)
    order = np.empty(Vcap, np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    V = lib.mfx_graph_pass(
        p(ks), p(cs), E, W, k,
        p(node_words), p(out_deg), p(in_deg), p(root), p(offset),
        p(link_count), p(is_cycle), p(prefix_id), p(suffix_id), p(order),
    )
    if V < 0:
        return None
    return (node_words[:V], int(V), out_deg[:V], in_deg[:V], root[:V],
            offset[:V], link_count[:V], is_cycle[:V].astype(bool),
            prefix_id, suffix_id, order[:V])


_unitig_configured = False


def _unitig_lib() -> Optional[ctypes.CDLL]:
    global _unitig_configured
    lib = fastq_native._load()
    if lib is None or not hasattr(lib, "mfx_unitig_build"):
        return None
    if not _unitig_configured:
        lib.mfx_unitig_build.restype = ctypes.c_long
        lib.mfx_unitig_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ] + [ctypes.c_void_p] * 5
        _unitig_configured = True
    return lib


def unitig_build(order: np.ndarray, offset: np.ndarray,
                 link_count: np.ndarray, is_cycle: np.ndarray,
                 node_keys: np.ndarray, k: int) -> Optional[Tuple]:
    """Bulk unitig assembly (one sequential pass over the chain order).
    Returns (U, seq_codes, seq_bounds, chain_bounds, depth, circular) or
    None when the native library is unavailable."""
    lib = _unitig_lib()
    if lib is None:
        return None
    V, W = node_keys.shape
    if V == 0 or W > 2 or k > 31:
        return None
    U = int(np.count_nonzero(np.asarray(offset) == 0))
    total = V + U * (k - 1)
    o = np.ascontiguousarray(order, np.int32)
    off = np.ascontiguousarray(offset, np.int32)
    lc = np.ascontiguousarray(link_count, np.uint32)
    cyc = np.ascontiguousarray(is_cycle, np.uint8)
    nk = np.ascontiguousarray(node_keys, np.uint32)
    chain_bounds = np.empty(U + 1, np.int64)
    seq_bounds = np.empty(U + 1, np.int64)
    seq_codes = np.empty(total, np.uint8)
    depth = np.empty(U, np.float64)
    circular = np.empty(U, np.uint8)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    got = lib.mfx_unitig_build(
        p(o), p(off), p(lc), p(cyc), p(nk), V, W, k,
        p(chain_bounds), p(seq_bounds), p(seq_codes), p(depth), p(circular),
    )
    if got != U:
        return None
    return U, seq_codes, seq_bounds, chain_bounds, depth, circular.astype(bool)
