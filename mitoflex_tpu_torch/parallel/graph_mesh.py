"""Sharded de Bruijn graph + unitig pass over a device mesh.

Port of mitoflex_tpu/parallel/graph_mesh.py. The node table is
range-partitioned over the mesh by its first key word, with the uniform
boundaries of the sharded k-mer counter (the node table is a both-strand
set): shard j owns the ascending unique k-mers of range j, so ``global id =
base_j + local row`` is the single-device id, and every label derived from
the ids (degrees, roots, offsets, link counts, cycle flags, edge endpoint
ids) is the single-device pass's, field for field.

- The edges split into contiguous row ranges of the sorted edge table. (The
  reference striped them round-robin so that no fixed-capacity bucket would
  overflow; exact split sizes cannot overflow, and a contiguous range keeps
  its edges' prefixes sorted and their shared nodes on one shard.)
- Each shard merges its edges' prefixes with their sorted suffixes into its
  local node set with both endpoints' local ranks (``kmer.union_merge``,
  the one-pass merge kernel K3 on a card), adds up each local node's out-
  and in-degree contributions, and routes its local nodes with them to
  their owners (one all_to_all). An owner merges the sorted runs it
  received (K3 again), numbers its unique nodes, sums the degree
  contributions (``index_add_``) and answers each received row with its
  local id; the ids go back along the same routes.
- A second exchange on the same routes carries each local node's unique
  predecessor candidate (the prefix id and count of its one local in-edge),
  which the owner reduces with ``scatter_reduce("amax")``.
- Unitig labelling is pointer doubling for ``ceil(log2(V + 1))`` rounds,
  one id-routed exchange a round (queries sorted by id, cut at the owners'
  id bases, answered by the owner's gather, routed back), then the cycle
  break at the minimum node id and a re-rank, as in ops/dbg.py. Distances
  are int64, so no cap is needed where the reference capped its int32
  distances below 2**30.

Every step launches every shard's work before it reads anything back to
the host.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from ..convert import MASK32, to_device
from ..ops import dbg as dbg_ops
from ..ops import kmer as kmer_ops
from ..ops import psort
from .mesh import DeviceMesh, _inner_boundaries, _range_cuts, exchange, route_back, row_bounds


def _merge_runs_with_positions(runs: Sequence[torch.Tensor]):
    """Merge sorted key runs ``[W, m_i]`` pairwise (K3 on a card) with each
    row's position in their concatenation as payload: ``(keys [W, M],
    positions [M] int64)``."""
    dev = runs[0].device
    off = np.cumsum([0] + [r.shape[1] for r in runs])
    level = [(r, torch.arange(off[i], off[i + 1], dtype=torch.int32, device=dev)[None])
             for i, r in enumerate(runs)]
    while len(level) > 1:
        nxt = [psort.merge_sorted_runs_onepass(a[0], a[1], b[0], b[1])
               for a, b in zip(level[::2], level[1::2])]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    keys, pos = level[0]
    return keys, pos[0].to(torch.int64)


def _id_gather(mesh: DeviceMesh, tables: List[torch.Tensor], queries: List[torch.Tensor],
               bases: List[int]) -> List[torch.Tensor]:
    """Distributed gather: for each query id of each shard, the columns of
    the owner's ``tables[j]`` ``[C, V_j]`` at that id, as ``[C, Q]`` in query
    order."""
    n = mesh.size
    sorted_q, cuts = [], []
    for q in queries:
        s, perm = torch.sort(q)
        b = torch.tensor(bases[1:-1], dtype=s.dtype, device=s.device)
        ends = torch.tensor([0, s.shape[0]], dtype=torch.int64, device=s.device)
        cuts.append(torch.cat([ends[:1], torch.searchsorted(s, b), ends[1:]]))
        sorted_q.append((s, perm))
    recv = exchange(mesh, [[s] for s, _ in sorted_q], [c.tolist() for c in cuts])
    answers = [tables[j][:, torch.cat([cols[0] for cols in recv[j]]) - bases[j]]
               for j in range(n)]
    back = route_back(mesh, answers, recv)
    out = []
    for (s, perm), vals in zip(sorted_q, back):
        full = torch.empty_like(vals)
        full[:, perm] = vals
        out.append(full)
    return out


def graph_pass_sharded(mesh: DeviceMesh, edge_words: List[torch.Tensor],
                       edge_counts: List[torch.Tensor], k: int):
    """Distributed graph + unitig labelling. Shard i holds ``edge_words[i]``
    ``[W, E_i]``, a contiguous row range of the sorted (k+1)-mer edge table,
    and its counts ``[E_i]`` (int64, clamped to uint32), on its device.

    Returns ``(nodes, edges)``: per shard j the owned node table and labels
    ``(node_words [W, V_j], out_deg, in_deg, root, offset, link_count,
    is_cycle)`` with global ids, and per shard i its edges' ``(prefix_id,
    suffix_id)``."""
    n = mesh.size
    inner = _inner_boundaries(n, False)

    # ---- local node sets, degree contributions, routes -------------------
    lazy = []
    for ew in edge_words:
        pre, suf = dbg_ops.edge_prefix_suffix(ew, k)
        s, new, ra, rb = kmer_ops.union_merge(pre, suf)
        m = s.shape[1]
        od = torch.zeros(m, dtype=torch.int64, device=s.device).index_add_(
            0, ra, torch.ones_like(ra))
        idg = torch.zeros(m, dtype=torch.int64, device=s.device).index_add_(
            0, rb, torch.ones_like(rb))
        # unique-row bounds of the key ranges: unique rows before each merged cut
        before = torch.cat([torch.zeros(1, dtype=torch.int64, device=s.device),
                            torch.cumsum(new.to(torch.int64), 0)])
        lazy.append((s, new, ra, rb, od, idg, before[_range_cuts(s[0], inner)]))
    local, cuts = [], []
    for s, new, ra, rb, od, idg, c in lazy:
        u = s[:, new]
        U = u.shape[1]
        local.append((u, ra, rb, od[:U], idg[:U]))
        cuts.append(c.tolist())

    # ---- owners: unique nodes, ids, degrees -------------------------------
    recv = exchange(mesh, [[u, od, idg] for u, _, _, od, idg in local], cuts)
    owned = []
    for runs in recv:
        keys, pos = _merge_runs_with_positions([cols[0] for cols in runs])
        new = kmer_ops._row_diff(keys)
        rank_of = torch.empty_like(pos)
        rank_of[pos] = torch.cumsum(new.to(torch.int64), 0) - 1
        m = pos.shape[0]
        od = torch.zeros(m, dtype=torch.int64, device=keys.device).index_add_(
            0, rank_of, torch.cat([cols[1] for cols in runs]))
        idg = torch.zeros(m, dtype=torch.int64, device=keys.device).index_add_(
            0, rank_of, torch.cat([cols[2] for cols in runs]))
        owned.append((keys, new, rank_of, od, idg))
    nodes = []
    for keys, new, rank_of, od, idg in owned:
        table = keys[:, new]
        V = table.shape[1]
        nodes.append((table, rank_of, od[:V], idg[:V]))
    bases = np.cumsum([0] + [t.shape[1] for t, _, _, _ in nodes]).tolist()
    V = bases[-1]

    # ---- edge endpoint ids -------------------------------------------------
    back = route_back(mesh, [rank_of for _, rank_of, _, _ in nodes], recv)
    edges, cand = [], []
    for i, (ids, (u, ra, rb, _, idg)) in enumerate(zip(back, local)):
        # local ids back from each owner in range order, plus the owner's base
        owner_of = torch.bucketize(torch.arange(ids.shape[0], device=ids.device),
                                   torch.tensor(cuts[i][1:-1], device=ids.device),
                                   right=True)
        gid = ids + torch.tensor(bases[:-1], device=ids.device)[owner_of]
        pre_id, suf_id = gid[ra], gid[rb]
        edges.append((pre_id, suf_id))
        # the prefix id and count of each local node's one local in-edge
        U = u.shape[1]
        pred = torch.full((U,), -1, dtype=torch.int64, device=u.device)
        pred[rb] = pre_id
        cnt = torch.full((U,), -1, dtype=torch.int64, device=u.device)
        cnt[rb] = edge_counts[i]
        one = idg == 1
        cand.append([torch.where(one, pred, -1), torch.where(one, cnt, -1)])

    # ---- owners: unique predecessors, linkable prev ------------------------
    recv2 = exchange(mesh, cand, cuts)
    state = []
    for j, ((table, rank_of, od, idg), runs) in enumerate(zip(nodes, recv2)):
        Vj = table.shape[1]
        dev = table.device
        self_id = bases[j] + torch.arange(Vj, device=dev)
        picked = []
        for c in (0, 1):
            vals = torch.cat([cols[c] for cols in runs])
            best = torch.full((rank_of.shape[0],), -1, dtype=torch.int64, device=dev)
            best.scatter_reduce_(0, rank_of, vals, "amax")
            picked.append(best[:Vj])
        one_in = idg == 1
        pred = torch.where(one_in, picked[0], self_id)
        state.append((self_id, od, idg, one_in, pred, picked[1]))
    pred_od = _id_gather(mesh, [od[None] for _, od, _, _, _, _ in state],
                         [pred for _, _, _, _, pred, _ in state], bases)
    prev, link = [], []
    for (self_id, _, _, one_in, pred, pcnt), pod in zip(state, pred_od):
        linkable = one_in & (pod[0] == 1) & (pred != self_id)
        prev.append(torch.where(linkable, pred, self_id))
        link.append(torch.where(linkable, pcnt, 0))

    # ---- pointer doubling, cycle break, re-rank ----------------------------
    iters = max(1, math.ceil(math.log2(V + 1)))
    self_ids = [s[0] for s in state]

    def rank(prev0):
        jump = list(prev0)
        dist = [(p != s).to(torch.int64) for p, s in zip(prev0, self_ids)]
        minid = [s.clone() for s in self_ids]
        for _ in range(iters):
            got = _id_gather(mesh, [torch.stack(x) for x in zip(jump, dist, minid)],
                             jump, bases)
            dist = [d + g[1] for d, g in zip(dist, got)]
            minid = [torch.minimum(m, g[2]) for m, g in zip(minid, got)]
            jump = [g[0] for g in got]
        return jump, dist, minid

    _, dist, minid = rank(prev)
    on_cycle = [d >= V for d in dist]
    is_break = [c & (s == m) for c, s, m in zip(on_cycle, self_ids, minid)]
    prev2 = [torch.where(b, s, p) for b, s, p in zip(is_break, self_ids, prev)]
    link = [torch.where(b, 0, lc) for b, lc in zip(is_break, link)]
    root, offset, _ = rank(prev2)
    nodes_out = [(table, od, idg, r, o, lc, c) for (table, _, _, _), (_, od, idg, _, _, _),
                 r, o, lc, c in zip(nodes, state, root, offset, link, on_cycle)]
    return nodes_out, edges


def graph_unitig_pass_mesh(mesh: DeviceMesh, keys: np.ndarray, counts: np.ndarray,
                           k: int) -> dbg_ops.GraphPass:
    """Split the solid edge table (``keys`` [E, W] uint32, sorted, E > 0;
    ``counts`` [E]) into contiguous row ranges over the mesh, run the
    distributed pass, and join the shards' parts on the mesh's first device
    into a ``GraphPass`` equal, field for field, to ``dbg.graph_unitig_pass``
    on the whole table (tests/test_torch_graph_mesh.py). Nothing falls back
    to one device: no exchange has a capacity to overflow."""
    E = len(keys)
    if E == 0:
        raise ValueError("graph_unitig_pass_mesh: no edges")
    b = row_bounds(E, mesh.size)
    ew = [to_device(np.ascontiguousarray(keys[b[j]:b[j + 1]].T), dev)
          for j, dev in enumerate(mesh.devices)]
    ec = [torch.from_numpy(np.minimum(counts[b[j]:b[j + 1]], MASK32).astype(np.int64))
          .to(dev) for j, dev in enumerate(mesh.devices)]
    nodes, edges = graph_pass_sharded(mesh, ew, ec, k)
    prim = mesh.primary

    def cat(parts, dim=-1):
        return torch.cat([p.to(prim, non_blocking=True) for p in parts], dim)

    node_words, out_deg, in_deg, root, offset, link, cyc = (
        cat(list(f)) for f in zip(*nodes))
    prefix_id, suffix_id = (cat(list(f)) for f in zip(*edges))
    return dbg_ops.GraphPass(
        node_words=node_words, n_nodes=node_words.shape[1], out_deg=out_deg,
        in_deg=in_deg, root=root, offset=offset, link_count=link, is_cycle=cyc,
        prefix_id=prefix_id, suffix_id=suffix_id,
        edge_valid=torch.ones(E, dtype=torch.bool, device=prim),
    )
