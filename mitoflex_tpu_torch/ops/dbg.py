"""De Bruijn graph pass and unitig extraction.

Port of mitoflex_tpu/ops/dbg.py. The graph is a sorted table of solid
(k+1)-mer edges (both strands) over dense node ids: nodes are the sorted
unique k-mer prefixes/suffixes of the edges, so node ids — and the unitig
roots, offsets and cycle flags derived from them — match the reference
exactly. ``graph_unitig_pass`` runs on tensors (gathers and scatters are
fine on a GPU: the reference's sort-joins were TPU workarounds); the JAX
``fori_loop`` of pointer doubling becomes a Python loop of gathers. The
node table and the edges' endpoint ids come from one merge of the edges'
prefixes (in order already, as the edge table is sorted) with their sorted
suffixes (``kmer.union_ranks``, the one-pass merge kernel K3 on a card).
``graph_unitig_pass_host`` is the CPU device's path through the native C++
engine (mitoflex_tpu/native/graph.cpp).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..convert import graph_pass_to_numpy, i32_bits, to_device
from . import kmer as kmer_ops

BASES_PER_WORD = kmer_ops.BASES_PER_WORD
_MASK32 = 0xFFFFFFFF


def edge_prefix_suffix(edge_words: torch.Tensor, k: int):
    """Split (k+1)-mer keys [W, E] into k-mer prefix and suffix keys.
    Keys are left-aligned, so the prefix is the key with base k zeroed and
    the suffix a 2-bit left shift across words."""
    W = edge_words.shape[0]
    kw, kt = divmod(k, BASES_PER_WORD)
    u = edge_words.to(torch.int64) & _MASK32
    mask = _MASK32 ^ (0x3 << (2 * (BASES_PER_WORD - 1 - kt)))
    prefix = u.clone()
    prefix[kw] &= mask
    suffix = (u << 2) & _MASK32
    if W > 1:
        suffix[:-1] |= u[1:] >> 30
    return i32_bits(prefix), i32_bits(suffix)


class GraphPass(NamedTuple):
    """Result of one graph + unitig pass. The port's tensor pass has exact
    sizes (V nodes, E edges); the host pass holds numpy arrays."""

    node_words: object   # [W, V] int32 tensor (host pass: W uint32 arrays)
    n_nodes: int
    out_deg: object      # [V]
    in_deg: object       # [V]
    root: object         # [V] unitig id (start-node index)
    offset: object       # [V] position within the unitig
    link_count: object   # [V] multiplicity of edge prev->v (0 at starts)
    is_cycle: object     # [V] bool, node on a circular unitig
    prefix_id: object    # [E] edge endpoint node ids
    suffix_id: object    # [E]
    edge_valid: object   # [E] bool
    # host pass only: nodes pre-sorted by (root, offset)
    order: object = None


def graph_unitig_pass(edge_words: torch.Tensor, edge_counts: torch.Tensor,
                      k: int) -> GraphPass:
    """Node table, degrees and unitig labelling for an edge set.

    edge_words: [W, E] int32 key words of the solid (k+1)-mers, sorted
    (so their k-prefixes are sorted too, which the node table's merge
    needs); edge_counts: [E] multiplicities (clamped to uint32 by the
    caller)."""
    dev = edge_words.device
    E = edge_counts.shape[0]
    prefix, suffix = edge_prefix_suffix(edge_words, k)
    node_words, V, prefix_id, suffix_id = kmer_ops.union_ranks(prefix, suffix)
    out_deg = torch.bincount(prefix_id, minlength=V)
    in_deg = torch.bincount(suffix_id, minlength=V)

    # unique predecessor where in_deg == 1 (one writer per such node)
    vidx = torch.arange(V, device=dev)
    in1 = torch.full((V,), -1, dtype=torch.int64, device=dev)
    in1[suffix_id] = prefix_id
    cnt1 = torch.zeros(V, dtype=torch.int64, device=dev)
    cnt1[suffix_id] = edge_counts.to(torch.int64)
    one_in = in_deg == 1
    pred = torch.where(one_in, in1, vidx)
    linkable = one_in & (out_deg[pred] == 1) & (pred != vidx)
    prev = torch.where(linkable, pred, vidx)
    link_count = torch.where(linkable, cnt1, 0)

    iters = max(1, math.ceil(math.log2(V + 1)))

    def rank(prev0):
        jump = prev0
        dist = (jump != vidx).to(torch.int64)
        minid = vidx
        for _ in range(iters):
            dist = dist + dist[jump]
            minid = torch.minimum(minid, minid[jump])
            jump = jump[jump]
        return jump, dist, minid

    jump, dist, minid = rank(prev)
    # cycle test by DISTANCE: a chain node's dist is its (< V) distance to
    # the root, a cycle node's doubles every round to 2**iters >= V + 1.
    # (jump[jump] != jump misses cycles whose length divides 2**iters, e.g.
    # a circular genome of exactly 2**m distinct k-mers.)
    on_cycle = dist >= V
    # break each cycle at its minimum node, then rank again
    is_break = on_cycle & (vidx == minid)
    prev2 = torch.where(is_break, vidx, prev)
    link_count = torch.where(is_break, 0, link_count)
    jump, dist, _ = rank(prev2)
    return GraphPass(
        node_words=node_words, n_nodes=V, out_deg=out_deg, in_deg=in_deg,
        root=jump, offset=dist, link_count=link_count, is_cycle=on_cycle,
        prefix_id=prefix_id, suffix_id=suffix_id,
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
    )


def graph_unitig_pass_host(keys: np.ndarray, counts: np.ndarray, k: int) -> GraphPass:
    """The CPU device's graph pass (k <= 31, so node k-mers pack into
    uint64): the native O(E + V) engine, whose ids and labels match the
    tensor pass exactly. Without the native library it runs the tensor pass
    on the CPU. keys: [E, W] uint32 valid rows; counts: [E]."""
    from mitoflex_tpu.native import graph_native

    E, W = keys.shape
    nat = graph_native.graph_pass(keys, counts, k)
    if nat is None:
        return graph_unitig_pass(
            to_device(np.ascontiguousarray(keys.T), "cpu"),
            torch.from_numpy(np.minimum(counts, _MASK32).astype(np.int64)), k,
        )
    (node_words, V, out_deg, in_deg, root, offset, link_count,
     is_cycle, prefix_id, suffix_id, order) = nat
    return GraphPass(
        node_words=[node_words[:, w] for w in range(W)],
        n_nodes=V, out_deg=out_deg, in_deg=in_deg, root=root,
        offset=offset, link_count=link_count, is_cycle=is_cycle,
        prefix_id=prefix_id, suffix_id=suffix_id,
        edge_valid=np.ones(E, bool), order=order,
    )


# ------------------------------------------------------------ host decoding
class UnitigSet(NamedTuple):
    """Struct-of-arrays unitig table (numpy); strings decode lazily."""

    n: int
    seq_codes: np.ndarray    # [total_bases] uint8 base codes (0..3), concatenated
    seq_bounds: np.ndarray   # [n+1] int64 — unitig j's bases are codes[b[j]:b[j+1]]
    depth: np.ndarray        # [n] float64 — mean internal link multiplicity
    circular: np.ndarray     # [n] bool
    chain_nodes: np.ndarray  # [total_nodes] int32 node ids in chain order
    chain_bounds: np.ndarray # [n+1] int64
    node_keys: np.ndarray    # [n_nodes, W] uint32 — sorted node k-mer keys

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.seq_bounds)

    @property
    def chain_counts(self) -> np.ndarray:
        return np.diff(self.chain_bounds)

    @property
    def entry(self) -> np.ndarray:
        return self.chain_nodes[self.chain_bounds[:-1]]

    @property
    def exit(self) -> np.ndarray:
        return self.chain_nodes[self.chain_bounds[1:] - 1]

    def seq_str(self, j: int) -> str:
        codes = self.seq_codes[self.seq_bounds[j] : self.seq_bounds[j + 1]]
        return _DECODE_LUT[codes].tobytes().decode()


_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def unitig_set_from_pass(gp: GraphPass, k: int) -> UnitigSet:
    """Group nodes by root, order by offset, assemble base codes in bulk.
    Each unitig appears once per strand; :func:`dedup_strand_mask` picks
    one. A host pass's precomputed chain order takes the native walk."""
    gp = graph_pass_to_numpy(gp)
    n = gp.n_nodes
    node_keys = np.stack(gp.node_words, axis=1)
    if n > 0 and gp.order is not None and node_keys.shape[1] <= 2 and k <= 31:
        from mitoflex_tpu.native import graph_native

        nat = graph_native.unitig_build(
            gp.order, gp.offset, gp.link_count, gp.is_cycle, node_keys, k,
        )
        if nat is not None:
            U, seq_codes, seq_bounds, chain_bounds, depth, circular = nat
            return UnitigSet(U, seq_codes, seq_bounds, depth, circular,
                             gp.order, chain_bounds, node_keys)
    if n == 0:
        z64 = np.zeros(1, np.int64)
        return UnitigSet(0, np.zeros(0, np.uint8), z64, np.zeros(0),
                         np.zeros(0, bool), np.zeros(0, np.int32), z64,
                         node_keys)
    root, offset, cyc = gp.root, gp.offset, gp.is_cycle
    link = gp.link_count.astype(np.float64)
    if gp.order is not None:
        order = gp.order
    else:
        order = np.lexsort((offset, root)).astype(np.int32)
    r_sorted = root[order]
    starts = np.flatnonzero(
        np.concatenate([[True], r_sorted[1:] != r_sorted[:-1]])
    )
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    U = len(starts)
    chain_bounds = np.concatenate([[0], np.cumsum(counts)])
    firsts = order[starts]

    # unitig j spans k + counts[j] - 1 bases; node i > 0 contributes its
    # last base at position (k-1)+i, node 0 its full k-mer
    seq_lens = counts + (k - 1)
    seq_bounds = np.concatenate([[0], np.cumsum(seq_lens)])
    seq_codes = np.empty(int(seq_bounds[-1]), np.uint8)
    w_last, t_last = divmod(k - 1, BASES_PER_WORD)
    last_base = (
        (node_keys[:, w_last] >> (2 * (BASES_PER_WORD - 1 - t_last))) & 0x3
    ).astype(np.uint8)
    u_of = np.repeat(np.arange(U, dtype=np.int64), counts)
    pos = np.arange(n, dtype=np.int64) + (k - 1) * (u_of + 1)
    seq_codes[pos] = last_base[order]
    fk = node_keys[firsts]
    head_starts = seq_bounds[:-1]
    for c in range(k - 1):
        w, t = divmod(c, BASES_PER_WORD)
        seq_codes[head_starts + c] = (
            (fk[:, w] >> (2 * (BASES_PER_WORD - 1 - t))) & 0x3
        ).astype(np.uint8)

    cs = np.concatenate([[0.0], np.cumsum(link[order])])
    link_sum = cs[chain_bounds[1:]] - cs[chain_bounds[:-1]]
    depth = np.where(counts > 1, link_sum / np.maximum(counts - 1, 1), 0.0)
    return UnitigSet(U, seq_codes, seq_bounds, depth, cyc[firsts],
                     order, chain_bounds, node_keys)


def _rc_ids_of(node_keys: np.ndarray, nodes: np.ndarray, k: int) -> np.ndarray:
    """RC node ids for a subset of nodes; a missing RC (impossible in a
    both-strand graph) maps to the node itself."""
    if len(nodes) == 0:
        return nodes.astype(np.int64)
    rc = kmer_ops.np_revcomp_keys(node_keys[nodes], k)
    ids = kmer_ops.np_searchsorted_keys(node_keys, rc)
    ids = np.clip(ids, 0, len(node_keys) - 1)
    miss = (node_keys[ids] != rc).any(axis=1)
    return np.where(miss, nodes, ids)


def dedup_strand_mask(uset: UnitigSet, k: int) -> np.ndarray:
    """Keep-mask selecting one strand per unitig: canonical id =
    min(entry, rc_id[exit]) for linear unitigs, and the minimum over the
    chain of min(id, rc_id) for circular ones."""
    if uset.n == 0:
        return np.zeros(0, bool)
    entry = uset.entry.astype(np.int64)
    exit_ = uset.exit.astype(np.int64)
    canon = np.minimum(entry, _rc_ids_of(uset.node_keys, exit_, k))
    circ = uset.circular
    if circ.any():
        csel = np.repeat(circ, uset.chain_counts)
        cnodes = uset.chain_nodes[csel].astype(np.int64)
        both_min = np.minimum(cnodes, _rc_ids_of(uset.node_keys, cnodes, k))
        ccounts = uset.chain_counts[circ]
        cb = np.concatenate([[0], np.cumsum(ccounts)[:-1]])
        canon[circ] = np.minimum.reduceat(both_min, cb)
    _, first_idx = np.unique(canon, return_index=True)
    keep = np.zeros(uset.n, bool)
    keep[first_idx] = True
    return keep
