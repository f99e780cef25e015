"""Covariance-model CYK alignment (cmsearch equivalent, tRNA scale).

Replaces Infernal ``cmsearch`` for the tRNA models (reference hot loop #7:
annotation_tookit.py:380-482 runs cmsearch per 22 CMs and parses the WUSS
fold of each alignment). Two-stage search like Infernal's own pipeline:

1. the CM's embedded HMMER3 filter profile (models/cm.py) is scanned with
   the device Viterbi engine (ops/phmm.py) to find candidate windows —
   this is the data-volume stage and runs on the device;
2. candidate windows (tRNA scale: <= 128 nt, ~200 states) get an exact
   CYK parse with traceback, vectorized over [i, j] span matrices per
   state (host numpy; small, cold path). The traceback emits the aligned
   sequence and a WUSS fold string derived from the model's model tree, so
   the downstream anticodon logic can run the same structure walk as the
   reference (bio/wuss.py).

The rRNA models (CLEN 952 / 1630, 3-5k states) use stage 2b instead:
:func:`cyk_banded`, a banded CYK anchored on the p7 filter envelope
(Infernal's own HMM-banded strategy, simplified to colinear interpolation
bands). Each state's subtree generates a contiguous consensus interval
[cl, cr); under the envelope's linear model-to-window map the span
boundaries i and j are banded around est(cl) and est(cr) with a fixed
slack, so each state stores a small [i-band, j-band] block instead of the
full [L+1, L+1] deck — memory drops from O(S*L^2) (59 TB for 16s) to
O(S*slack^2) (~200 MB), and the DP gives true CM bit scores for rRNA.

CYK formulation: alpha[v][i][j] = best log-odds (bits) of state v's
subtree generating window span [i, j) —

    E:  0 on the diagonal;            S/D: pure transition max;
    ML: emit x_i, span shrinks left;  MR: emit x_{j-1}, shrinks right;
    MP: emit pair (x_i, x_{j-1});     IL/IR: self-loops solved by a
    linear sweep along i (resp. j);   B: max-plus product over the split.

States are processed in decreasing index (children always have larger
indices in the Infernal numbering).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models import cm as cm_models
from ..models.cm import B, D, E, IL, IR, ML, MP, MR, S

NEG = -1e30


# ------------------------------------------------------- consensus layout
@dataclass
class ConsensusLayout:
    cons: str                  # consensus residues, model coords 0..clen-1
    wuss: str                  # consensus structure, same coords
    node_of_pos: List[int]     # node index per consensus position
    side_of_pos: List[str]     # 'L' | 'R'
    pos_of_node: Dict[Tuple[int, str], int]


def consensus_layout(model: cm_models.CovarianceModel) -> ConsensusLayout:
    """Emit consensus positions in model-tree order and classify each into
    WUSS characters (pairs bracketed by bifurcation depth; unpaired by
    enclosing-loop type)."""
    nodes = model.nodes

    def b_children(node_idx: int) -> Tuple[int, int]:
        for sid in nodes[node_idx].state_ids:
            if model.stype[sid] == B:
                left = int(model.node_of[model.cfirst[sid]])
                right = int(model.node_of[model.cnum[sid]])
                return left, right
        raise ValueError("BIF node without B state")

    out: List[Tuple[int, str]] = []          # (node, side)
    pair_nodes: List[int] = []

    def walk(idx: int) -> None:
        kind = nodes[idx].kind
        if kind == "END":
            return
        if kind == "BIF":
            l, r = b_children(idx)
            walk(l)
            walk(r)
            return
        if kind in ("MATL", "MATP"):
            out.append((idx, "L"))
        walk(idx + 1)
        if kind in ("MATR", "MATP"):
            out.append((idx, "R"))
        if kind == "MATP":
            pair_nodes.append(idx)

    walk(0)

    pos_of_node = {(n, s): i for i, (n, s) in enumerate(out)}
    clen = len(out)
    wuss = [""] * clen
    pairs = sorted(
        (pos_of_node[(n, "L")], pos_of_node[(n, "R")]) for n in pair_nodes
    )
    # WUSS bracket level: a stem with no nested stems is a hairpin stem
    # '<>'; exactly one direct child keeps the child's level (interior
    # loop/bulge); >= 2 direct children (a multiloop) steps the level up.
    level: Dict[Tuple[int, int], int] = {}

    def pair_level(p: Tuple[int, int]) -> int:
        if p in level:
            return level[p]
        l0, r0 = p
        inner = [(l, r) for l, r in pairs if l0 < l and r < r0]
        direct = [
            (l, r) for l, r in inner
            if not any(l2 < l and r < r2 for l2, r2 in inner if (l2, r2) != (l, r))
        ]
        if not direct:
            lv = 0
        elif len(direct) == 1:
            lv = pair_level(direct[0])
        else:
            lv = max(pair_level(c) for c in direct) + 1
        level[p] = lv
        return lv

    brackets = ["<>", "()", "[]", "{}"]
    for p in pairs:
        b = brackets[min(pair_level(p), 3)]
        wuss[p[0]], wuss[p[1]] = b[0], b[1]

    # unpaired classification by innermost enclosing pair
    pairs.sort()
    for i in range(clen):
        if wuss[i]:
            continue
        enclosing = [(l, r) for l, r in pairs if l < i < r]
        if not enclosing:
            wuss[i] = ":"
            continue
        l0, r0 = max(enclosing, key=lambda p: p[0])
        inner = [(l, r) for l, r in pairs if l0 < l and r < r0]
        # direct children of (l0, r0): inner pairs not nested in other inner
        direct = [
            (l, r) for l, r in inner
            if not any(l2 < l and r < r2 for l2, r2 in inner if (l2, r2) != (l, r))
        ]
        if not direct:
            wuss[i] = "_"
        elif len(direct) == 1:
            wuss[i] = "-"
        else:
            wuss[i] = ","
    cons = []
    for n, s in out:
        nd = nodes[n]
        cons.append(nd.cons_left if s == "L" else nd.cons_right)
    return ConsensusLayout(
        cons="".join(cons),
        wuss="".join(wuss),
        node_of_pos=[n for n, _ in out],
        side_of_pos=[s for _, s in out],
        pos_of_node=pos_of_node,
    )


# ---------------------------------------------------------------- CYK DP
@dataclass
class CykAlignment:
    score: float
    seq_from: int              # 0-based window coords, inclusive
    seq_to: int
    aligned_seq: str           # over consensus positions (+ inserts)
    aligned_fold: str
    mdl_from: int              # 1-based consensus coords
    mdl_to: int
    residue_of_pos: Dict[int, int]  # consensus pos -> window index (matches)


def _emit_single_scores(model, window):
    """esc[v, t] for single-emitting states over window residues."""
    return _emit_single_scores_batch(model, window[None, :])[:, 0]


def _emit_single_scores_batch(model, windows):
    """esc[v, b, t] for single-emitting states over batched window residues
    (``windows`` is [B, L] int codes, 4 = invalid/pad)."""
    S_ = model.n_states
    Bn, L = windows.shape
    esc = np.full((S_, Bn, L), NEG, np.float32)
    ok = windows < 4
    idx = np.clip(windows, 0, 3)
    single = np.isin(model.stype, (ML, MR, IL, IR))
    # [S_sel, B, L] lookup, masked to valid residues
    vals = model.emit_single[single][:, idx]          # [S_sel, B, L]
    esc[single] = np.where(ok[None], vals, NEG)
    return esc


def _cyk_fill(model, windows, real_len, local):
    """Batched exact CYK fill: ``windows`` [B, L] padded with code 4.

    Returns (alpha [Sn, B, L+1, L+1], esc, el_deck, lc). Arithmetic is
    identical to the former per-window loop — each op just carries a
    leading batch axis — so tracebacks reconstruct bit-identical paths."""
    Bn, L = windows.shape
    Sn = model.n_states
    esc = _emit_single_scores_batch(model, windows)
    ok = windows < 4
    widx = np.clip(windows, 0, 3)

    lc = cm_models.local_config(model) if local else None
    el_deck = None
    if local:
        bb = np.arange(L + 1)
        # EL absorbs span residues at el_selfsc bits each — only within
        # the REAL window (padding must not be absorbable)
        el_deck = np.where(
            (bb[None, None, :] >= bb[None, :, None])
            & (bb[None, None, :] <= real_len[:, None, None]),
            (bb[None, None, :] - bb[None, :, None]) * lc.el_selfsc,
            NEG,
        ).astype(np.float32)                           # [B, L+1, L+1]

    alpha = np.full((Sn, Bn, L + 1, L + 1), NEG, np.float32)

    stype = model.stype
    cfirst = model.cfirst
    cnum = model.cnum
    trans = model.trans

    # E deck: empty span anywhere inside the real window
    ediag = np.full((Bn, L + 1, L + 1), NEG, np.float32)
    dd = np.arange(L + 1)
    for b in range(Bn):
        ediag[b, dd[: real_len[b] + 1], dd[: real_len[b] + 1]] = 0.0

    def children(v):
        return list(range(cfirst[v], cfirst[v] + cnum[v]))

    if local:
        el_sub = el_deck[:, 1:, :L]                    # shared MP-shift view
    pair_ok = ok[:, :, None] & ok[:, None, :]          # [B, L, L]
    scratch = np.empty((Bn, L, L + 1), np.float32)     # ML/IL child temp

    for v in range(Sn - 1, -1, -1):
        st = stype[v]
        if st == E:
            alpha[v] = ediag
            continue
        if st == B:
            al, ar = alpha[int(cfirst[v])], alpha[int(cnum[v])]
            # max-plus product over the split point, one window at a time
            # (a batched [B, L+1, L+1, L+1] temp thrashes caches)
            for b in range(Bn):
                np.max(al[b, :, :, None] + ar[b, None, :, :], axis=1,
                       out=alpha[v, b])
            continue
        kids = children(v)
        ts = trans[v]
        if local:
            ts = ts + lc.trans_adj[v]
        # all writes land directly in alpha[v]; NEG-init then region maxes
        base = alpha[v]
        base.fill(NEG)
        self_t = None
        for ci, c in enumerate(kids):
            if c == v:
                self_t = float(ts[ci])
                continue
            if st in (S, D):
                np.maximum(base, alpha[c] + ts[ci], out=base)
            elif st in (ML, IL):
                np.add(alpha[c][:, 1:, :], ts[ci], out=scratch)
                np.maximum(base[:, :L, :], scratch, out=base[:, :L, :])
            elif st in (MR, IR):
                sc = scratch.reshape(Bn, L + 1, L)
                np.add(alpha[c][:, :, :L], ts[ci], out=sc)
                np.maximum(base[:, :, 1:], sc, out=base[:, :, 1:])
            elif st == MP:
                sc = scratch[:, :, :L]
                np.add(alpha[c][:, 1:, :L], ts[ci], out=sc)
                np.maximum(base[:, :L, 1:], sc, out=base[:, :L, 1:])
        if local and lc.end_sc[v] > NEG / 2:
            # local end: an extra pseudo-child EL whose deck scores the
            # remaining span at el_selfsc bits per residue
            t_el = float(lc.end_sc[v])
            if st in (S, D):
                np.maximum(base, el_deck + t_el, out=base)
            elif st in (ML, IL):
                np.maximum(base[:, :L, :], el_deck[:, 1:, :] + t_el,
                           out=base[:, :L, :])
            elif st in (MR, IR):
                np.maximum(base[:, :, 1:], el_deck[:, :, :L] + t_el,
                           out=base[:, :, 1:])
            else:  # MP
                np.maximum(base[:, :L, 1:], el_sub + t_el,
                           out=base[:, :L, 1:])
        # add emissions in place; rows/cols that can't emit drop to NEG
        if st in (ML, IL):
            base[:, :L, :] += esc[v][:, :, None]
            base[:, L, :] = NEG
        elif st in (MR, IR):
            base[:, :, 1:] += esc[v][:, None, :]
            base[:, :, 0] = NEG
        elif st == MP:
            pair_scores = model.emit_pair[v].reshape(4, 4)
            base[:, :L, 1:] += np.where(
                pair_ok, pair_scores[widx[:, :, None], widx[:, None, :]], NEG
            )
            base[:, L, :] = NEG
            base[:, :, 0] = NEG
        # self loops (IL along i descending, IR along j ascending)
        if self_t is not None:
            if st == IL:
                for i in range(L - 1, -1, -1):
                    cand = esc[v, :, i, None] + self_t + base[:, i + 1, :]
                    np.maximum(base[:, i, :], cand, out=base[:, i, :])
            elif st == IR:
                for j in range(1, L + 1):
                    cand = esc[v, :, j - 1, None] + self_t + base[:, :, j - 1]
                    np.maximum(base[:, :, j], cand, out=base[:, :, j])
        np.clip(base, NEG, None, out=base)
    return alpha, esc, el_deck, lc


def cyk_align(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    local: bool = False,
) -> Optional[CykAlignment]:
    """Exact CYK over a window (base codes). Returns the best local-span
    alignment or None if nothing scores above NEG/2.

    ``local=True`` enables Infernal-style local mode (cmsearch's default;
    models/cm.py local_config): the parse may BEGIN at any internal
    MATP/MATL/MATR/BIF node and may END any eligible subtree early
    through an EL state that emits the rest of the span at ~0 bits per
    residue. This is what scores 5'/3'-truncated hits sensibly — model
    regions falling off the window edge are skipped by a begin/end
    instead of a ruinous delete chain. Glocal (default) is kept for the
    tRNA path, whose anticodon validation needs the full cloverleaf
    traceback."""
    return cyk_align_many(model, [np.asarray(window)], local=local)[0]


def cyk_align_many(
    model: cm_models.CovarianceModel,
    windows: List[np.ndarray],
    local: bool = False,
    max_batch_bytes: int = 256 << 20,
) -> List[Optional[CykAlignment]]:
    """Exact CYK over a BATCH of windows for one model (VERDICT round-1
    #9: the per-envelope tRNA CYK calls were the annotate stage's serial
    host hot spot). All span decks gain a leading batch axis, so the
    ~2*Sn-step Python state loop runs once per batch instead of once per
    window; tracebacks stay per-window on each window's own deck slice.
    Windows of different lengths are padded with the invalid code 4
    (unemittable -> scores and spans are unaffected)."""
    if not windows:
        return []
    Sn = model.n_states
    lens = np.array([len(w) for w in windows], np.int64)
    L = int(lens.max())
    # cap batch so alpha [Sn, B, L+1, L+1] stays bounded
    per = Sn * (L + 1) * (L + 1) * 4
    chunk = max(1, int(max_batch_bytes // max(per, 1)))
    out: List[Optional[CykAlignment]] = []
    for s in range(0, len(windows), chunk):
        out.extend(_cyk_align_chunk(model, windows[s : s + chunk], local))
    return out


def _cyk_align_chunk(model, windows, local):
    Bn = len(windows)
    lens = np.array([len(w) for w in windows], np.int64)
    L = int(lens.max())
    wins = np.full((Bn, L), 4, np.int64)
    for b, w in enumerate(windows):
        wins[b, : len(w)] = w
    alpha, esc, el_deck, lc = _cyk_fill(model, wins, lens, local)
    Sn = model.n_states
    results: List[Optional[CykAlignment]] = []
    for b in range(Bn):
        Lb = int(lens[b])
        # restrict the readout to spans inside the real window
        sub = alpha[:, b, : Lb + 1, : Lb + 1]
        if local:
            # local begins: the parse attaches at the best-scoring
            # candidate state instead of the ROOT_S deck
            best, bv, bi, bj = NEG, 0, 0, 0
            for v in range(Sn):
                bsc = float(lc.begin_sc[v])
                if bsc <= NEG / 2:
                    continue
                flat = int(np.argmax(sub[v]))
                i, j = divmod(flat, Lb + 1)
                val = float(sub[v][i, j]) + bsc
                if val > best:
                    best, bv, bi, bj = val, v, i, j
        else:
            bv = 0
            flat = np.argmax(sub[0])
            bi, bj = divmod(int(flat), Lb + 1)
            best = float(sub[0][bi, bj])
        if best < NEG / 2 or bj <= bi:
            results.append(None)
            continue
        results.append(
            _traceback(
                model, wins[b, :Lb], alpha[:, b], esc[:, b],
                el_deck[b] if el_deck is not None else None,
                lc, local, best, bv, bi, bj,
            )
        )
    return results


def _traceback(model, window, alpha, esc, el_deck, lc, local,
               best, bv, bi, bj) -> CykAlignment:
    """Reconstruct the winning parse from a filled deck (single window)."""
    L = len(window)
    stype = model.stype
    cfirst = model.cfirst
    cnum = model.cnum
    trans = model.trans
    ok = window < 4
    widx = np.clip(window, 0, 3)

    def children(v):
        return list(range(cfirst[v], cfirst[v] + cnum[v]))
    layout = consensus_layout(model)
    residue_of_pos: Dict[int, int] = {}
    deleted: set = set()
    inserts: Dict[int, List[int]] = {}  # after-consensus-pos -> window idxs

    def emit_insert(v, t):
        node = int(model.node_of[v])
        # anchor inserts after the nearest consensus position of this node
        anchor = layout.pos_of_node.get((node, "L"), layout.pos_of_node.get((node, "R"), -1))
        inserts.setdefault(anchor, []).append(t)

    stack = [(bv, bi, bj)]
    guard = 0
    while stack:
        guard += 1
        if guard > 100000:
            break
        v, i, j = stack.pop()
        st = stype[v]
        cur = alpha[v][i, j]
        if st == E:
            continue
        if st == B:
            al, ar = alpha[int(cfirst[v])], alpha[int(cnum[v])]
            k = int(np.argmax(al[i, :] + ar[:, j]))
            stack.append((int(cfirst[v]), i, k))
            stack.append((int(cnum[v]), k, j))
            continue
        kids = children(v)
        ts = trans[v]
        if local:
            ts = ts + lc.trans_adj[v]
        found = False
        node = int(model.node_of[v])
        for ci, c in enumerate(kids):
            if st in (S, D):
                val = alpha[c][i, j] + ts[ci]
                ni, nj = i, j
                emit = None
            elif st in (ML, IL):
                if i >= L or i >= j:
                    continue
                val = esc[v, i] + ts[ci] + (alpha[c][i + 1, j] if c != v else NEG)
                if c == v:
                    val = esc[v, i] + ts[ci] + alpha[v][i + 1, j]
                ni, nj = i + 1, j
                emit = ("L", i)
            elif st in (MR, IR):
                if j <= i or j - 1 < 0:
                    continue
                val = esc[v, j - 1] + ts[ci] + alpha[c][i, j - 1]
                ni, nj = i, j - 1
                emit = ("R", j - 1)
            elif st == MP:
                if j - i < 2:
                    continue
                pe = model.emit_pair[v].reshape(4, 4)
                if not (ok[i] and ok[j - 1]):
                    continue
                val = pe[widx[i], widx[j - 1]] + ts[ci] + alpha[c][i + 1, j - 1]
                ni, nj = i + 1, j - 1
                emit = ("P", (i, j - 1))
            else:
                continue
            if abs(val - cur) < 1e-3:
                if st == MP:
                    residue_of_pos[layout.pos_of_node[(node, "L")]] = emit[1][0]
                    residue_of_pos[layout.pos_of_node[(node, "R")]] = emit[1][1]
                elif st == ML:
                    residue_of_pos[layout.pos_of_node[(node, "L")]] = emit[1]
                elif st == MR:
                    residue_of_pos[layout.pos_of_node[(node, "R")]] = emit[1]
                elif st in (IL, IR):
                    emit_insert(v, emit[1])
                elif st == D:
                    key = (node, "L") if (node, "L") in layout.pos_of_node else (node, "R")
                    if stype[v] == D and key in layout.pos_of_node:
                        deleted.add(layout.pos_of_node[key])
                stack.append((c, ni, nj))
                found = True
                break
        if not found and local and lc.end_sc[v] > NEG / 2:
            # local end: emit this state's residues, then EL absorbs the
            # remaining span — the subtree below is truncated away
            t_el = float(lc.end_sc[v])
            if st == S:
                val = t_el + el_deck[i, j]
                emit = None
            elif st == ML and i < j and i < L:
                val = esc[v, i] + t_el + el_deck[i + 1, j]
                emit = ("L", i)
            elif st == MR and j > i and j - 1 >= 0:
                val = esc[v, j - 1] + t_el + el_deck[i, j - 1]
                emit = ("R", j - 1)
            elif st == MP and j - i >= 2 and ok[i] and ok[j - 1]:
                pe = model.emit_pair[v].reshape(4, 4)
                val = pe[widx[i], widx[j - 1]] + t_el + el_deck[i + 1, j - 1]
                emit = ("P", (i, j - 1))
            else:
                val, emit = NEG, None
            if abs(val - cur) < 1e-3:
                if emit is not None and emit[0] == "P":
                    residue_of_pos[layout.pos_of_node[(node, "L")]] = emit[1][0]
                    residue_of_pos[layout.pos_of_node[(node, "R")]] = emit[1][1]
                elif emit is not None and emit[0] == "L":
                    residue_of_pos[layout.pos_of_node[(node, "L")]] = emit[1]
                elif emit is not None and emit[0] == "R":
                    residue_of_pos[layout.pos_of_node[(node, "R")]] = emit[1]
                found = True
        if not found:
            # numeric mismatch; stop cleanly
            continue

    # D states in MATP nodes delete one or both sides; approximate: any
    # consensus position with no residue is a deletion
    decode = "ACGTN"
    seq_chars: List[str] = []
    fold_chars: List[str] = []
    for p in range(len(layout.cons)):
        r = residue_of_pos.get(p)
        seq_chars.append(decode[int(window[r])] if r is not None else "-")
        fold_chars.append(layout.wuss[p])
        for t in sorted(inserts.get(p, [])):
            seq_chars.append(decode[int(window[t])].lower())
            fold_chars.append(".")

    touched = [p for p in residue_of_pos]
    mdl_from = min(touched) + 1 if touched else 1
    mdl_to = max(touched) + 1 if touched else len(layout.cons)
    return CykAlignment(
        score=best,
        seq_from=bi,
        seq_to=bj - 1,
        aligned_seq="".join(seq_chars),
        aligned_fold="".join(fold_chars),
        mdl_from=mdl_from,
        mdl_to=mdl_to,
        residue_of_pos=residue_of_pos,
    )


# --------------------------------------------------------------- banded CYK
def node_subtree_spans(model: cm_models.CovarianceModel) -> List[Tuple[int, int]]:
    """Per NODE half-open consensus interval [cl, cr) generated by the
    node's model-tree subtree (including its own MATL/MATR/MATP emissions).
    Nodes are in preorder, so every subtree is a contiguous consensus run;
    empty subtrees (END et al.) give zero-width intervals at their seam."""
    nodes = model.nodes
    spans: List[Tuple[int, int]] = [(0, 0)] * len(nodes)
    pos = [0]  # consensus positions emitted so far

    def b_children(idx: int) -> Tuple[int, int]:
        for sid in nodes[idx].state_ids:
            if model.stype[sid] == B:
                return (int(model.node_of[model.cfirst[sid]]),
                        int(model.node_of[model.cnum[sid]]))
        raise ValueError("BIF node without B state")

    def walk(idx: int) -> None:
        start = pos[0]
        kind = nodes[idx].kind
        if kind == "END":
            spans[idx] = (start, start)
            return
        if kind == "BIF":
            l, r = b_children(idx)
            walk(l)
            walk(r)
            spans[idx] = (start, pos[0])
            return
        if kind in ("MATL", "MATP"):
            pos[0] += 1
        walk(idx + 1)
        if kind in ("MATR", "MATP"):
            pos[0] += 1
        spans[idx] = (start, pos[0])

    walk(0)
    return spans


def cyk_banded(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
) -> Optional[CykAlignment]:
    """Banded CYK over ``window`` (base codes) with colinear bands.

    ``anchor`` = (w0, w1, p0, p1): window coordinates [w0, w1] of the p7
    filter envelope and the 0-based consensus positions [p0, p1] it spans
    (hmm_from-1, hmm_to-1). Consensus position p is expected near
    est(p) = w0 + (p - p0) * (w1 - w0) / (p1 - p0); every state's span
    boundaries are banded est +- slack, CLAMPED to the window — states
    whose consensus region extrapolates past either window edge (a
    5'/3'-truncated hit) get pinpoint zero-width bands there instead of
    excluding the parse. Returns score + window coordinates (no
    traceback — rRNA consumers need coords/score only), or None when
    nothing scores.

    ``local=True`` adds Infernal-style local begins/ends (models/cm.py
    local_config; cmsearch's default mode, and the mode the ECMLC
    E-value calibration line refers to): truncated model regions are
    then skipped via a local begin or an EL end rather than a delete
    chain, giving sensible bit scores for hits running off contig ends.
    mdl_from/mdl_to report the winning begin state's consensus subtree.

    Exactness: with slack >= window length this reduces to the full CYK
    (tested against cyk_align); with tight bands it is a lower bound on
    the true CYK score, like any banded aligner."""
    L = len(window)
    Sn = model.n_states
    stype, cfirst, cnum, trans = model.stype, model.cfirst, model.cnum, model.trans
    esc = _emit_single_scores(model, window)
    ok = window < 4
    widx = np.clip(window, 0, 3)

    lc = cm_models.local_config(model) if local else None

    def el_fetch(a0: int, a1: int, b0: int, b1: int) -> np.ndarray:
        """EL pseudo-child deck over boundary ranges [a0,a1) x [b0,b1)."""
        ii = np.arange(a0, a1)[:, None]
        jj = np.arange(b0, b1)[None, :]
        valid = (jj >= ii) & (ii >= 0) & (jj <= L)
        return np.where(valid, (jj - ii) * lc.el_selfsc, NEG).astype(np.float32)

    w0, w1, p0, p1 = anchor
    clen = model.clen
    rate = (w1 - w0) / max(p1 - p0, 1)

    def est(p: float) -> float:
        return w0 + (p - p0) * rate

    spans = node_subtree_spans(model)

    # per-state band: [ilo, ihi) x [jlo, jhi) over boundary coords 0..L
    ilo = np.zeros(Sn, np.int32)
    ihi = np.zeros(Sn, np.int32)
    jlo = np.zeros(Sn, np.int32)
    jhi = np.zeros(Sn, np.int32)
    for v in range(Sn):
        cl, cr = spans[int(model.node_of[v])]
        ci = est(cl)
        cj = est(cr)
        # clamp into [0, L]: estimates past a window edge (truncated hit)
        # collapse to a pinpoint band AT the edge, never an empty band
        ilo[v] = min(max(0, int(np.floor(ci)) - slack), L)
        ihi[v] = min(L, max(int(np.ceil(ci)) + slack, 0)) + 1
        jlo[v] = min(max(0, int(np.floor(cj)) - slack), L)
        jhi[v] = min(L, max(int(np.ceil(cj)) + slack, 0)) + 1

    blocks: List[Optional[np.ndarray]] = [None] * Sn

    def fetch(c: int, i0: int, i1: int, j0: int, j1: int) -> np.ndarray:
        """Child c's alpha over boundary ranges [i0,i1) x [j0,j1), NEG
        outside c's band."""
        out = np.full((i1 - i0, j1 - j0), NEG, np.float32)
        bi0, bi1 = max(i0, ilo[c]), min(i1, ihi[c])
        bj0, bj1 = max(j0, jlo[c]), min(j1, jhi[c])
        if bi0 < bi1 and bj0 < bj1:
            out[bi0 - i0 : bi1 - i0, bj0 - j0 : bj1 - j0] = blocks[c][
                bi0 - ilo[c] : bi1 - ilo[c], bj0 - jlo[c] : bj1 - jlo[c]
            ]
        return out

    for v in range(Sn - 1, -1, -1):
        st = stype[v]
        i0, i1, j0, j1 = int(ilo[v]), int(ihi[v]), int(jlo[v]), int(jhi[v])
        ii = np.arange(i0, i1)
        jj = np.arange(j0, j1)
        span_ok = jj[None, :] >= ii[:, None]          # j >= i
        if st == E:
            blk = np.where(jj[None, :] == ii[:, None], 0.0, NEG).astype(np.float32)
            blocks[v] = blk
            continue
        if st == B:
            l, r = int(cfirst[v]), int(cnum[v])
            m0 = max(int(jlo[l]), int(ilo[r]))
            m1 = min(int(jhi[l]), int(ihi[r]))
            if m0 >= m1:
                # children's seam bands miss each other: dead state
                blocks[v] = np.full((i1 - i0, j1 - j0), NEG, np.float32)
                continue
            lb = fetch(l, i0, i1, m0, m1)             # [I, M]
            rb = fetch(r, m0, m1, j0, j1)             # [M, J]
            blk = (lb[:, :, None] + rb[None, :, :]).max(axis=1)
            blocks[v] = np.where(span_ok, blk, NEG).astype(np.float32)
            continue

        kids = list(range(int(cfirst[v]), int(cfirst[v]) + int(cnum[v])))
        ts = trans[v]
        if local:
            ts = ts + lc.trans_adj[v]
        blk = np.full((i1 - i0, j1 - j0), NEG, np.float32)
        self_t = None
        for ci_, c in enumerate(kids):
            t = float(ts[ci_])
            if c == v:
                self_t = t
                continue
            if st in (S, D):
                cand = fetch(c, i0, i1, j0, j1) + t
            elif st in (ML, IL):
                cand = fetch(c, i0 + 1, i1 + 1, j0, j1) + t
            elif st in (MR, IR):
                cand = fetch(c, i0, i1, j0 - 1, j1 - 1) + t
            elif st == MP:
                cand = fetch(c, i0 + 1, i1 + 1, j0 - 1, j1 - 1) + t
            else:
                continue
            np.maximum(blk, cand, out=blk)
        if local and lc.end_sc[v] > NEG / 2:
            t_el = float(lc.end_sc[v])
            if st in (S, D):
                cand = el_fetch(i0, i1, j0, j1) + t_el
            elif st in (ML, IL):
                cand = el_fetch(i0 + 1, i1 + 1, j0, j1) + t_el
            elif st in (MR, IR):
                cand = el_fetch(i0, i1, j0 - 1, j1 - 1) + t_el
            else:  # MP
                cand = el_fetch(i0 + 1, i1 + 1, j0 - 1, j1 - 1) + t_el
            np.maximum(blk, cand, out=blk)
        # emissions
        if st in (ML, IL):
            em = np.full(i1 - i0, NEG, np.float32)
            sel = ii < L
            em[sel] = esc[v, ii[sel]]
            blk = blk + em[:, None]
        elif st in (MR, IR):
            em = np.full(j1 - j0, NEG, np.float32)
            sel = jj - 1 >= 0
            em[sel] = esc[v, jj[sel] - 1]
            blk = blk + em[None, :]
        elif st == MP:
            ps = model.emit_pair[v].reshape(4, 4)
            em = np.full((i1 - i0, j1 - j0), NEG, np.float32)
            isel = (ii < L) & ok[np.clip(ii, 0, L - 1)]
            jsel = (jj - 1 >= 0) & ok[np.clip(jj - 1, 0, L - 1)]
            if isel.any() and jsel.any():
                em[np.ix_(isel, jsel)] = ps[
                    np.ix_(widx[ii[isel]], widx[jj[jsel] - 1])
                ]
            blk = blk + em
        # self loops within the band
        if self_t is not None:
            if st == IL:
                for r_ in range(blk.shape[0] - 2, -1, -1):
                    i = i0 + r_
                    if i >= L:
                        continue
                    cand = esc[v, i] + self_t + blk[r_ + 1, :]
                    np.maximum(blk[r_, :], cand, out=blk[r_, :])
            elif st == IR:
                for c_ in range(1, blk.shape[1]):
                    j = j0 + c_
                    if j - 1 < 0 or j - 1 >= L:
                        continue
                    cand = esc[v, j - 1] + self_t + blk[:, c_ - 1]
                    np.maximum(blk[:, c_], cand, out=blk[:, c_])
        blk = np.where(span_ok, blk, NEG).astype(np.float32)
        np.clip(blk, NEG, None, out=blk)
        blocks[v] = blk

    if local:
        best, bi, bj, bspan = NEG, 0, 0, (0, model.clen)
        for v in range(Sn):
            bsc = float(lc.begin_sc[v])
            if bsc <= NEG / 2 or blocks[v] is None:
                continue
            flat = int(np.argmax(blocks[v]))
            ri, rj = divmod(flat, blocks[v].shape[1])
            val = float(blocks[v][ri, rj]) + bsc
            if val > best:
                best = val
                bi = int(ilo[v]) + ri
                bj = int(jlo[v]) + rj
                bspan = spans[int(model.node_of[v])]
        mdl_from, mdl_to = bspan[0] + 1, bspan[1]
        # A 3'-truncated hit (the case local ENDs exist for) absorbs the
        # model suffix through EL, but the begin state's subtree span can't
        # see that — it would report mdl_to ~= clen. The banded kernel does
        # no traceback, so when the alignment runs into the window's right
        # edge, clamp model coverage to the p7 envelope's hmm_to (anchor
        # p1), which tracked where the profile actually stopped matching.
        if bj >= L and mdl_to > p1 + 1:
            mdl_to = p1 + 1
    else:
        root = blocks[0]
        flat = int(np.argmax(root))
        ri, rj = divmod(flat, root.shape[1])
        best = float(root[ri, rj])
        bi = int(ilo[0]) + ri
        bj = int(jlo[0]) + rj
        mdl_from, mdl_to = 1, model.clen
    if best < NEG / 2 or bj <= bi:
        return None
    return CykAlignment(
        score=best, seq_from=bi, seq_to=bj - 1,
        aligned_seq="", aligned_fold="",
        mdl_from=mdl_from, mdl_to=mdl_to, residue_of_pos={},
    )
