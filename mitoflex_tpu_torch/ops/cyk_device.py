"""Banded CYK on tensors: the rRNA rescore's DP on the run's device.

Port of mitoflex_tpu/ops/cyk_device.py (``cyk_banded_device``). The host
numpy banded CYK (ops/cyk.py ``cyk_banded``) walks a few thousand states
with a handful of small numpy calls each; this module runs the same DP as
tensor steps over states in decreasing index (children always have larger
indices in the Infernal numbering), on a banded deck ``[S, W, W]`` that
stays on the device: only the ``[S]`` block maxima and their positions come
back to the host.

The contract is the reference's:

- **Uniform band width** ``W = 2 * slack + 2`` for every state. Band origins
  are clamped into ``[0, L + 1 - W]``, so each block always covers its numpy
  counterpart (which shrinks at the window's edges): the banded score is >=
  the numpy kernel's and <= the exact CYK's, and equal to the exact one
  whenever the bands contain the optimal parse.
- **Bifurcation offsets are checked**: a band offset between a B state and
  its children of a block width or more raises ``ValueError``.
- **Scores only** (like the numpy banded kernel): the rRNA consumers need
  coordinates and the bit score, never a traceback. The truncation clamp of
  ``mdl_to`` at the window's right edge is kept.

What differs from the reference's program is what its compiler forced:

- a child's block aligned to its parent's band is a slice of the deck (the
  overlap of the two bands, computed on the host from the origins), not a
  roll and a mask;
- emissions are table lookups: one gather per call gives every state's
  single-residue scores along the padded window, and a state reads its band
  as a slice of that; a pair state gathers its 4 x 4 table by the two
  residue codes. No matrix product touches a bit score;
- the choice between a bifurcation and a regular state is a host branch on
  the model's tables, which are known on the host: no device
  synchronisation happens until the maxima are read;
- IL / IR self-loops stay the reference's closed form: blk[i] = max(blk[i],
  d[i] + blk[i+1]) unrolls to max_{k>=i}(g[k] + blk[k]) - g[i] with g the
  prefix sums of d, one ``flip`` + ``torch.cummax``. The step for an invalid
  residue is clipped at -3e4 so that the prefix sums stay in float32 range
  (any such path is dead anyway). Prefix sums are order-dependent in the
  last bits, so scores agree with the reference within 1e-3 bits and
  coordinates exactly.

The model's tables are built once per (model, mode, device) and parked on
the device, keyed by the model's ``id`` with a weak reference as guard.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import cm as cm_models
from ..models.cm import B, D, E, IL, IR, ML, MP, MR, S
from .cyk import NEG, CykAlignment, node_subtree_spans

_DEAD = -3.0e4          # clipped self-loop step for invalid residues

_KIND_OF = {S: 0, D: 0, ML: 1, IL: 1, MR: 2, IR: 2, MP: 3}

_STATIC: dict = {}


def _model_static(model, local: bool, dev: torch.device) -> dict:
    """Anchor- and window-independent tables, cached per (model, mode,
    device). If the original model was collected and a new one reuses its
    id, the stale entry is rebuilt instead of silently mis-scoring."""
    key = (id(model), local, str(dev))
    hit = _STATIC.get(key)
    if hit is not None and hit["ref"]() is model:
        return hit
    Sn = model.n_states
    stype, cfirst, cnum = model.stype, model.cfirst, model.cnum
    trans = model.trans.astype(np.float32)
    lc = cm_models.local_config(model) if local else None
    if local:
        trans = trans + lc.trans_adj[:, None]

    spans = node_subtree_spans(model)
    span_arr = np.asarray(spans, np.int64)            # [nodes, 2]
    cl = span_arr[model.node_of, 0].astype(np.float64)
    cr = span_arr[model.node_of, 1].astype(np.float64)

    order = [v for v in range(Sn - 1, -1, -1) if stype[v] != E]
    # per scanned state: (v, kind, kids [(child, t)], self_t, end_sc) or,
    # for a B state, (v, -1, left child, right child)
    steps = []
    b_states, b_left, b_right = [], [], []
    for v in order:
        st = int(stype[v])
        if st == B:
            steps.append((v, -1, int(cfirst[v]), int(cnum[v])))
            b_states.append(v)
            b_left.append(int(cfirst[v]))
            b_right.append(int(cnum[v]))
            continue
        kids, self_t = [], None
        for ci_ in range(int(cnum[v])):
            c = int(cfirst[v]) + ci_
            if c == v:
                self_t = float(trans[v, ci_])
            else:
                kids.append((c, float(trans[v, ci_])))
        if self_t is not None and self_t <= NEG / 2:
            self_t = None
        end_sc = None
        if local and lc.end_sc[v] > NEG / 2:
            end_sc = float(lc.end_sc[v])
        steps.append((v, _KIND_OF[st], kids, self_t, end_sc))

    # emission tables with a fifth column / row for the invalid code
    single5 = np.full((Sn, 5), NEG, np.float32)
    single5[:, :4] = model.emit_single
    pair5 = np.full((Sn, 5, 5), NEG, np.float32)
    pair5[:, :4, :4] = model.emit_pair.reshape(Sn, 4, 4)
    static = dict(
        steps=steps, cl=cl, cr=cr, lc=lc, spans=spans,
        e_states=torch.from_numpy(np.flatnonzero(stype == E)).to(dev),
        b_states=np.asarray(b_states, np.int64),
        b_left=np.asarray(b_left, np.int64),
        b_right=np.asarray(b_right, np.int64),
        single5=torch.from_numpy(single5).to(dev),
        pair5=torch.from_numpy(pair5.reshape(Sn, 25)).to(dev),
        ref=weakref.ref(model),
    )
    # sweep entries whose model was collected (they pin device tensors)
    for k in [k for k, v in _STATIC.items() if v["ref"]() is None]:
        del _STATIC[k]
    _STATIC[key] = static
    return static


def _overlap(d: int, W: int) -> Tuple[int, int]:
    """Rows r of a parent block with 0 <= r + d < W, as [r0, r1)."""
    return max(0, -d), min(W, W - d)


def cyk_banded_device(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
    device=None,
) -> Optional[CykAlignment]:
    """Counterpart of ops/cyk.py ``cyk_banded`` on ``device`` (same anchor /
    slack / local semantics, scores and coordinates only). Bands are
    uniform and clamped inside the window, so they always contain the numpy
    kernel's bands: score(numpy banded) <= score(this) <= score(exact)."""
    dev = resolve_device(device)
    window = np.asarray(window)
    L = len(window)
    W = 2 * slack + 2
    st = _model_static(model, local, dev)
    lc = st["lc"]
    Sn = model.n_states

    w0, w1, p0, p1 = anchor
    rate = (w1 - w0) / max(p1 - p0, 1)
    omax = max(0, L + 1 - W)
    o_i = np.clip(np.floor(w0 + (st["cl"] - p0) * rate) - slack,
                  0, omax).astype(np.int64)
    o_j = np.clip(np.floor(w0 + (st["cr"] - p0) * rate) - slack,
                  0, omax).astype(np.int64)

    # bifurcation sanity: a child's block cannot be aligned to a band
    # further away than the block width (contiguous splits keep offsets
    # tiny; this can only trip on a degenerate anchor)
    vb, bl, br = st["b_states"], st["b_left"], st["b_right"]
    if len(vb):
        worst = max(
            np.abs(o_i[vb] - o_i[bl]).max(),
            np.abs(o_j[bl] - o_i[br]).max(),
            np.abs(o_j[vb] - o_j[br]).max(),
        )
        if worst >= W:
            raise ValueError("bifurcation band offset exceeds width")

    f32 = torch.float32
    # the window's codes with one leading pad (so that j - 1 >= 0) and pads
    # after it; 4 marks an invalid or absent residue
    wpad = np.full(L + W + 2, 4, np.int64)
    wpad[1: L + 1] = np.minimum(window, 4)
    wpad_t = torch.from_numpy(wpad).to(dev)
    esc = st["single5"][:, wpad_t]                     # [S, L + W + 2]
    pair5 = st["pair5"]
    el_selfsc = float(lc.el_selfsc) if local else 0.0

    iota = torch.arange(W, device=dev)
    # c - r of a block's cell, as integers in float32
    diff = (iota[None, :] - iota[:, None]).to(f32)
    oi_t = torch.from_numpy(o_i).to(dev)
    oj_t = torch.from_numpy(o_j).to(dev)

    deck = torch.full((Sn, W, W), NEG, dtype=f32, device=dev)
    # E states: the empty span anywhere inside the real window
    e_idx = st["e_states"]
    ii = oi_t[e_idx, None, None] + iota[None, :, None]
    jj = oj_t[e_idx, None, None] + iota[None, None, :]
    deck[e_idx] = torch.zeros((len(e_idx), W, W), dtype=f32, device=dev) \
        .masked_fill_(~((ii == jj) & (jj <= L)), NEG)

    oi_l, oj_l = o_i.tolist(), o_j.tolist()

    def fetch(c: int, di: int, dj: int) -> torch.Tensor:
        """Child c's block aligned to the parent band: out[r, m] =
        deck[c, r + di, m + dj], NEG where that leaves the block."""
        out = torch.full((W, W), NEG, dtype=f32, device=dev)
        r0, r1 = _overlap(di, W)
        c0, c1 = _overlap(dj, W)
        if r0 < r1 and c0 < c1:
            out[r0:r1, c0:c1] = deck[c, r0 + di: r1 + di, c0 + dj: c1 + dj]
        return out

    for step in st["steps"]:
        v, kind = step[0], step[1]
        oiv, ojv = oi_l[v], oj_l[v]
        if kind < 0:
            lch, rch = step[2], step[3]
            lb = fetch(lch, oiv - oi_l[lch], 0)
            rb = fetch(rch, oj_l[lch] - oi_l[rch], ojv - oj_l[rch])
            blk = (lb[:, :, None] + rb[None, :, :]).amax(dim=1)
        else:
            kids, self_t, end_sc = step[2], step[3], step[4]
            si = 1 if kind in (1, 3) else 0
            sj = 1 if kind in (2, 3) else 0
            blk = torch.full((W, W), NEG, dtype=f32, device=dev)
            for c, t in kids:
                di, dj = oiv + si - oi_l[c], ojv - sj - oj_l[c]
                r0, r1 = _overlap(di, W)
                c0, c1 = _overlap(dj, W)
                if r0 < r1 and c0 < c1:
                    sub = blk[r0:r1, c0:c1]
                    torch.maximum(
                        sub, deck[c, r0 + di: r1 + di, c0 + dj: c1 + dj] + t,
                        out=sub)
            if end_sc is not None:
                # local END pseudo-child: EL emits the remaining span
                # [i + si, j - sj) at el_selfsc bits per residue
                span = diff + float(ojv - sj - oiv - si)
                el = torch.where(span >= 0, span * el_selfsc, NEG)
                cut = L - (ojv - sj) + 1          # columns with el_j <= L
                if cut < W:
                    el[:, max(cut, 0):] = NEG
                blk = torch.maximum(blk, el + end_sc)
            # emissions: row r is residue o_i + r, column c residue
            # o_j + c - 1 (NEG where there is none or it is invalid)
            if kind == 1:
                em_i = esc[v, oiv + 1: oiv + 1 + W]
                blk = blk + em_i[:, None]
            elif kind == 2:
                em_j = esc[v, ojv: ojv + W]
                blk = blk + em_j[None, :]
            elif kind == 3:
                ci = wpad_t[oiv + 1: oiv + 1 + W]
                cj = wpad_t[ojv: ojv + W]
                blk = blk + pair5[v][ci[:, None] * 5 + cj[None, :]]
            # self-loops: reverse / forward cummax with prefix-sum offsets
            if self_t is not None and kind == 1:
                d_i = (em_i + self_t).clamp(min=_DEAD)
                # exclusive prefix sums, summed in the reference's order
                g = torch.cumsum(F.pad(d_i[:-1], (1, 0)), 0)
                blk = torch.cummax((blk + g[:, None]).flip(0), dim=0).values \
                    .flip(0) - g[:, None]
            elif self_t is not None and kind == 2:
                G = torch.cumsum((em_j + self_t).clamp(min=_DEAD), 0)
                blk = torch.cummax(blk - G[None, :], dim=1).values + G[None, :]
        # span validity: j >= i within the real window
        blk = torch.where(diff >= float(oiv - ojv), blk.clamp(min=NEG), NEG)
        if L - oiv + 1 < W:
            blk[max(L - oiv + 1, 0):, :] = NEG
        if L - ojv + 1 < W:
            blk[:, max(L - ojv + 1, 0):] = NEG
        deck[v] = blk

    flat = deck.reshape(Sn, W * W)
    m = flat.amax(dim=1).cpu().numpy()
    a = flat.argmax(dim=1).cpu().numpy()   # the first maximum of each block

    if local:
        begins = lc.begin_sc.copy()
    else:
        begins = np.full(Sn, NEG, np.float32)
        begins[0] = 0.0
    tot = m + begins
    bv = int(np.argmax(tot))
    best = float(tot[bv])
    ri, rj = divmod(int(a[bv]), W)
    bi = int(o_i[bv]) + ri
    bj = int(o_j[bv]) + rj
    if best < NEG / 2 or bj <= bi:
        return None
    if local:
        bspan = st["spans"][int(model.node_of[bv])]
        mdl_from, mdl_to = bspan[0] + 1, bspan[1]
        # same truncation clamp as the numpy kernel: when the hit runs
        # into the window's right edge the EL state absorbed the model
        # suffix, so cap coverage at the p7 envelope's hmm_to
        if bj >= L and mdl_to > anchor[3] + 1:
            mdl_to = anchor[3] + 1
    else:
        mdl_from, mdl_to = 1, model.clen
    return CykAlignment(
        score=best, seq_from=bi, seq_to=bj - 1,
        aligned_seq="", aligned_fold="",
        mdl_from=mdl_from, mdl_to=mdl_to, residue_of_pos={},
    )
