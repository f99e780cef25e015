"""Graph-cleaning analyses for one de Bruijn round: weak-link
disconnection, local low-depth removal, and bubble popping.

Capability parity with megahit_core `assemble`'s cleaning schedule as the
reference drives it (reference assemble/assemble_wrapper.py:269-286:
`bubble_level: 2, merge_len: 20, merge_similar: 0.95, disconnect_ratio:
0.1, low_local_ratio: 0.2, careful_bubble: kmer < kmax`), re-designed for
the edge-array graph of ops/dbg.py:

- the graph pass (device) hands back dense node ids, degrees and unitig
  labels; every analysis here is vectorized host numpy over those arrays
  (they are O(unitigs), tiny next to the k-mer tables);
- **weak links** (megahit Disconnect): at a branch node, out-edges whose
  multiplicity is < disconnect_ratio x the strongest sibling are cut
  (likewise in-edges). Edge counts are reverse-complement symmetric
  (both strands are counted), so the mirrored edge is cut in the same
  round and the bidirected graph stays consistent;
- **local low depth** (megahit RemoveLocalLowDepth): a short unitig whose
  depth is < low_local_ratio x the mean depth of its branch-neighbors is
  removed — the *local* complement of the global prune_depth gate;
- **bubbles** (megahit PopBubble / complex-bubble merge): unitigs that
  share a single predecessor node a and a single successor node d are
  parallel branches of a bubble. The deepest branch (ties broken by
  canonical sequence, which is orientation-symmetric) survives; others
  are popped when their length is within the level's bound and their
  sequence similarity to the winner is >= merge_similar. Multi-unitig
  ("complex") bubbles are popped by iteration: each fixpoint round pops
  the innermost simple bubbles, the freed chains merge in the next device
  pass, and the enclosing bubble becomes simple — same effect as
  megahit's path search, bounded by the cleaning round count.
- **careful_bubble**: popped branch sequences are returned so the caller
  can re-inject them at the next k (the reference carries bubble_seq.fa
  into `iterate -b`, assemble_wrapper.py:307-315).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_RC = str.maketrans("ACGT", "TGCA")


def _revcomp(s: str) -> str:
    return s.translate(_RC)[::-1]


def _canonical(s: str) -> str:
    r = _revcomp(s)
    return s if s <= r else r


def edit_distance(a: str, b: str) -> int:
    """Unit-cost Levenshtein distance, vectorized over DP rows.

    The in-row dependency cur[j] = min(m[j], cur[j-1]+1) is solved in
    closed form: cur[j] = j + min_{l<=j}(t[l]) with t[l] = m[l] - l, a
    prefix-min — standard trick for unit edit costs."""
    if a == b:
        return 0
    x = np.frombuffer(a.encode(), np.uint8)
    y = np.frombuffer(b.encode(), np.uint8)
    n = len(y)
    js = np.arange(n + 1, dtype=np.int32)
    prev = js.copy()
    t = np.empty(n + 1, np.int32)
    for i in range(1, len(x) + 1):
        m = np.minimum(prev[:-1] + (y != x[i - 1]), prev[1:] + 1)
        t[0] = i
        t[1:] = m - js[1:]
        prev = np.minimum.accumulate(t) + js
    return int(prev[-1])


def seq_similarity(a: str, b: str) -> float:
    """1 - editdist/maxlen (megahit's bubble similarity measure)."""
    if a == b:
        return 1.0
    if len(a) == len(b):
        x = np.frombuffer(a.encode(), np.uint8)
        y = np.frombuffer(b.encode(), np.uint8)
        return float((x == y).mean())
    return 1.0 - edit_distance(a, b) / max(len(a), len(b))


@dataclass
class CleanParams:
    """Knob set the reference fixes when invoking megahit_core assemble
    (assemble_wrapper.py:269-286)."""

    prune_depth: float = 2.0
    prune_level: int = 2
    bubble_level: int = 2
    merge_len: int = 20          # complex-bubble branch bound, x k bases
    merge_similar: float = 0.95
    disconnect_ratio: float = 0.1
    low_local_ratio: float = 0.2
    careful_bubble: bool = False


@dataclass
class PoppedBubble:
    seq: str
    depth: float


@dataclass
class CleanResult:
    bad_nodes: np.ndarray            # [n] bool — nodes to delete
    bad_edges: np.ndarray            # [E] bool — edges to cut (weak links)
    bubbles: List[PoppedBubble] = field(default_factory=list)

    @property
    def any(self) -> bool:
        return bool(self.bad_nodes.any() or self.bad_edges.any())


def weak_link_edges(
    pre: np.ndarray, suf: np.ndarray, ecnt: np.ndarray,
    out_deg: np.ndarray, in_deg: np.ndarray, ratio: float,
) -> np.ndarray:
    """Cut branch edges whose multiplicity is dwarfed by a sibling
    (megahit Disconnect, ratio = disconnect_ratio).

    Never flags a node's strongest edge, so no node is fully
    disconnected by this pass alone."""
    n = len(out_deg)
    E = len(pre)
    bad = np.zeros(E, dtype=bool)
    if ratio <= 0 or E == 0:
        return bad
    c = ecnt.astype(np.float64)
    out_max = np.zeros(n, np.float64)
    np.maximum.at(out_max, pre, c)
    in_max = np.zeros(n, np.float64)
    np.maximum.at(in_max, suf, c)
    bad |= (out_deg[pre] >= 2) & (c < ratio * out_max[pre]) & (c < out_max[pre])
    bad |= (in_deg[suf] >= 2) & (c < ratio * in_max[suf]) & (c < in_max[suf])
    return bad


def _single_neighbors(
    pre: np.ndarray, suf: np.ndarray, in_deg: np.ndarray, out_deg: np.ndarray,
    entry: np.ndarray, exit_: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each unitig: its unique predecessor node (or -1) and unique
    successor node (or -1).

    Scatter-based: ``in1[suf] = pre`` leaves an arbitrary winner at nodes
    with several in-edges, but the result is only read where in_deg == 1 —
    exactly one write, so it is exact. Two O(E) scatters replace the two
    O(E log E) argsorts (the former wall of this analysis at 10M+
    unitigs)."""
    n = len(in_deg)
    in1 = np.full(n, -1, np.int64)
    in1[suf] = pre
    out1 = np.full(n, -1, np.int64)
    out1[pre] = suf
    pred = np.where(in_deg[entry] == 1, in1[entry], -1)
    succ = np.where(out_deg[exit_] == 1, out1[exit_], -1)
    return pred, succ


def pop_bubbles(
    uset, pred: np.ndarray, succ: np.ndarray, k: int, params: CleanParams,
    bad_nodes: np.ndarray,
) -> List[PoppedBubble]:
    """Group non-circular unitigs by their (single-pred, single-succ) node
    pair; in each group of parallel branches keep the deepest and pop the
    rest, subject to the level's length bound and merge_similar.

    Candidate selection and grouping are bulk array ops over the
    :class:`~mitoflex_tpu_torch.ops.dbg.UnitigSet`; only actual bubble GROUPS
    (rare relative to unitigs) decode sequences for the similarity check.

    Orientation symmetry: the reverse-complement twin of every bubble is
    an independent group keyed by the mirrored node pair; because edge
    counts and the canonical-sequence tie-break are strand-symmetric, the
    same branch loses in both, keeping the bidirected graph consistent."""
    popped: List[PoppedBubble] = []
    if params.bubble_level <= 0 or uset.n == 0:
        return popped
    max_branch = (params.merge_len * k if params.bubble_level >= 2
                  else 2 * k + 2)
    lengths = uset.lengths
    cand = np.flatnonzero(
        (~uset.circular) & (pred >= 0) & (succ >= 0) & (pred != succ)
        & (lengths <= max_branch)
    )
    if len(cand) < 2:
        return popped
    cp, cs = pred[cand], succ[cand]
    order = np.lexsort((cs, cp))
    cp, cs, cand = cp[order], cs[order], cand[order]
    starts = np.flatnonzero(
        np.concatenate([[True], (cp[1:] != cp[:-1]) | (cs[1:] != cs[:-1])])
    )
    bounds = np.append(starts, len(cand))
    group_sizes = np.diff(bounds)
    for gi in np.flatnonzero(group_sizes >= 2):
        s, e = bounds[gi], bounds[gi + 1]
        idxs = cand[s:e]
        seqs = {int(j): uset.seq_str(int(j)) for j in idxs}
        ranked = sorted(
            idxs, key=lambda j: (-uset.depth[j], _canonical(seqs[int(j)])),
        )
        win_seq = seqs[int(ranked[0])]
        for j in ranked[1:]:
            if seq_similarity(win_seq, seqs[int(j)]) < params.merge_similar:
                continue
            bad_nodes[
                uset.chain_nodes[uset.chain_bounds[j] : uset.chain_bounds[j + 1]]
            ] = True
            if params.careful_bubble:
                popped.append(PoppedBubble(seqs[int(j)], float(uset.depth[j])))
    return popped


def analyze_round(
    uset, in_deg: np.ndarray, out_deg: np.ndarray,
    pre: np.ndarray, suf: np.ndarray, ecnt: np.ndarray,
    k: int, params: CleanParams,
) -> CleanResult:
    """One cleaning round over a finished graph pass: tips, global and
    local low depth, weak links, bubbles. Takes the struct-of-arrays
    :class:`~mitoflex_tpu_torch.ops.dbg.UnitigSet`; every analysis is bulk
    numpy with no per-unitig Python. Returns node/edge kill masks and
    (careful mode) the popped bubble sequences."""
    n = len(in_deg)
    bad_nodes = np.zeros(n, dtype=bool)
    tip_len = 2 * k
    drop_ratio = {0: 0.0, 1: 0.3, 2: 0.5, 3: 0.7}[params.prune_level]

    U = uset.n
    depths = uset.depth
    lengths = uset.lengths
    med_depth = float(np.median(depths[depths > 0])) if (depths > 0).any() else 0.0

    # --- weak links (edge-level) -----------------------------------------
    bad_edges = weak_link_edges(pre, suf, ecnt, out_deg, in_deg,
                                params.disconnect_ratio)

    # --- unitig endpoints + single neighbors ------------------------------
    entry = uset.entry.astype(np.int64)
    exit_ = uset.exit.astype(np.int64)
    pred, succ = _single_neighbors(pre, suf, in_deg, out_deg, entry, exit_)

    # --- local low depth (megahit RemoveLocalLowDepth analog) -------------
    if params.low_local_ratio > 0 and U:
        uidx = np.full(n, -1, np.int64)
        uidx[uset.chain_nodes] = np.repeat(
            np.arange(U, dtype=np.int64), uset.chain_counts
        )
        # branch edges connect exit(u_a) -> entry(u_b)
        branch = (out_deg[pre] != 1) | (in_deg[suf] != 1)
        ua, ub = uidx[pre[branch]], uidx[suf[branch]]
        ok = (ua >= 0) & (ub >= 0) & (ua != ub)
        nb_sum = np.zeros(U, np.float64)
        nb_cnt = np.zeros(U, np.float64)
        np.add.at(nb_sum, ua[ok], depths[ub[ok]])
        np.add.at(nb_cnt, ua[ok], 1.0)
        np.add.at(nb_sum, ub[ok], depths[ua[ok]])
        np.add.at(nb_cnt, ub[ok], 1.0)
        with np.errstate(invalid="ignore"):
            local_mean = np.where(nb_cnt > 0, nb_sum / np.maximum(nb_cnt, 1), 0.0)
    else:
        local_mean = np.zeros(U, np.float64)

    # --- tips + low depth, vectorized over the set -----------------------
    if U:
        dead_start = in_deg[entry] == 0
        dead_end = out_deg[exit_] == 0
        short = lengths < tip_len
        is_tip = (dead_start ^ dead_end) & short
        pos_depth = depths > 0
        low = (pos_depth & (depths < params.prune_depth)) | (
            (drop_ratio > 0) & pos_depth & (depths < drop_ratio * med_depth)
            & short
        )
        local_low = (
            (params.low_local_ratio > 0) & (local_mean > 0) & pos_depth
            & (depths < params.low_local_ratio * local_mean) & short
        )
        bad_u = (~uset.circular) & (is_tip | low | local_low)
        if bad_u.any():
            sel = np.repeat(bad_u, uset.chain_counts)
            bad_nodes[uset.chain_nodes[sel]] = True

    # --- bubbles -----------------------------------------------------------
    bubbles = pop_bubbles(uset, pred, succ, k, params, bad_nodes)
    return CleanResult(bad_nodes=bad_nodes, bad_edges=bad_edges, bubbles=bubbles)
