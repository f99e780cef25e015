"""Banded CYK on tensors: the rRNA rescore's DP on the run's device.

Port of mitoflex_tpu/ops/cyk_device.py (``cyk_banded_device``). The host
numpy banded CYK (ops/cyk.py ``cyk_banded``) walks a few thousand states
with a handful of small numpy calls each; this module runs the same DP over
states in decreasing index (children always have larger indices in the
Infernal numbering), on a banded deck ``[S, W, W]`` that stays on the
device: only the ``[S]`` block maxima and their first argmax cells come
back to the host.

On a card a call is one launch of the hand-written kernel of
``csrc/cyk.cu`` (one thread block on each SM takes the states in the
dispatch order of :func:`_schedule` and runs each as soon as its children
are done; at most ``KERNEL_MAX_W`` columns a band). On the CPU it is the
plain version ``cyk_banded_plain``, a Python loop of tensor steps over the
states (about 18 eager operations a state). Both feed the same host pick
(:func:`_pick`) from their ``[S]`` maxima and argmax cells, and both
derive their band origins from :func:`_origins`.

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
  coordinates exactly. The kernel sums them in the CPU's order (left to
  right, each sum in float64 and rounded to float32, as ``torch.cumsum``
  does on the CPU) and rounds every other operation as the plain version
  does, so on the same inputs it gives the CPU's maxima bit for bit.

The model's tables are built once per (model, mode, device) and parked on
the device, keyed by the model's ``id`` with a weak reference as guard.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import KernelLimitError
from ..device import resolve_device
from ..models import cm as cm_models
from ..models.cm import B, D, E, IL, IR, ML, MP, MR, S
from .cyk import NEG, CykAlignment, node_subtree_spans

_DEAD = -3.0e4          # clipped self-loop step for invalid residues

_KIND_OF = {S: 0, D: 0, ML: 1, IL: 1, MR: 2, IR: 2, MP: 3}

# the widest band the kernel takes (csrc/cyk.cu kMaxW): three child blocks,
# or the two operands of a bifurcation, W^2 float32 each, in one SM's shared
# memory
KERNEL_MAX_W = 128
# int32 words a scanned state takes in the kernel's step table
# (csrc/cyk.cu kStepWords); the fields are the _W_* offsets below
STEP_WORDS = 20
MAX_KIDS = 6
_W_V, _W_KIND, _W_NKIDS, _W_LEFT, _W_RIGHT, _W_KID, _W_T = 0, 1, 2, 3, 4, 5, 11
_W_SELF, _W_END, _W_FLAGS = 17, 18, 19
HAS_SELF, HAS_END = 1, 2

_STATIC: dict = {}
# per (device, stream): the kernel's sync buffer (int32: the work and done
# counters, then one ready flag a state) and the epoch of its last call
_SYNC: dict = {}
_SYNC_MIN_STATES = 4096


def _step_table(steps) -> np.ndarray:
    """The kernel's step table [n_scan, STEP_WORDS] int32, one row a
    scanned state in scan order: state, kind (-1 for B), child count, the B
    state's two children, up to MAX_KIDS (child, transition) pairs, the
    self-loop and local-end scores (NEG where absent) and the HAS_SELF /
    HAS_END flags. Scores are float32 bits; each is the float32 value the
    plain version's tensor operations round it to."""
    table = np.zeros((len(steps), STEP_WORDS), np.int32)
    fbits = table.view(np.float32)
    fbits[:, _W_T: _W_T + MAX_KIDS] = NEG
    fbits[:, _W_SELF] = NEG
    fbits[:, _W_END] = NEG
    for t, step in enumerate(steps):
        v, kind = step[0], step[1]
        table[t, _W_V], table[t, _W_KIND] = v, kind
        if kind < 0:
            table[t, _W_NKIDS] = 2
            table[t, _W_LEFT], table[t, _W_RIGHT] = step[2], step[3]
            continue
        kids, self_t, end_sc = step[2], step[3], step[4]
        if len(kids) > MAX_KIDS:
            raise ValueError(f"state {v} has {len(kids)} children; the kernel takes "
                             f"{MAX_KIDS}")
        table[t, _W_NKIDS] = len(kids)
        for k, (c, tr) in enumerate(kids):
            table[t, _W_KID + k] = c
            fbits[t, _W_T + k] = tr
        if self_t is not None:
            fbits[t, _W_SELF] = self_t
            table[t, _W_FLAGS] |= HAS_SELF
        if end_sc is not None:
            fbits[t, _W_END] = end_sc
            table[t, _W_FLAGS] |= HAS_END
    return table


def _schedule(table: np.ndarray, n_states: int) -> Tuple[np.ndarray, int]:
    """The kernel's dispatch order of the step table's rows and the
    schedule's depth. A state's level is 0 for an E state and else 1 more
    than its children's highest; the rows go level by level, in step-table
    order within a level, so that every child is dispatched before its
    parent and the states of one level can run at once. The depth is the
    number of levels (E included): the states on the longest chain of
    children, which bounds a call from below at one state's time each."""
    level = [0] * n_states                # E states stay at 0
    row_level = [0] * len(table)
    lv = level.__getitem__
    rows = table[:, :_W_T].tolist()       # state, kind, children, B's two, kids
    for t, row in enumerate(rows):
        kids = row[_W_LEFT: _W_RIGHT + 1] if row[_W_KIND] < 0 else \
            row[_W_KID: _W_KID + row[_W_NKIDS]]
        row_level[t] = level[row[_W_V]] = 1 + max(map(lv, kids), default=-1)
    order = np.argsort(np.asarray(row_level), kind="stable").astype(np.int32)
    return order, 1 + max(level, default=-1)


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
    e_states = np.flatnonzero(stype == E).astype(np.int32)
    static = dict(
        steps=steps, cl=cl, cr=cr, lc=lc, spans=spans,
        e_states=torch.from_numpy(e_states).to(dev),
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


def _origins(st: dict, L: int, anchor, slack: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every state's band origins (o_i, o_j) [S] int64, clamped into
    ``[0, L + 1 - W]``; ValueError when a bifurcation's band offset reaches
    the block width."""
    W = 2 * slack + 2
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
    return o_i, o_j


def _padded_codes(window: np.ndarray, W: int) -> np.ndarray:
    """The window's codes with one leading pad (so that j - 1 >= 0) and pads
    after it; 4 marks an invalid or absent residue."""
    L = len(window)
    wpad = np.full(L + W + 2, 4, np.int64)
    wpad[1: L + 1] = np.minimum(window, 4)
    return wpad


class BandedMaxima(NamedTuple):
    """A banded CYK's raw result before the host pick."""
    m: np.ndarray        # [S] float32, each state's block maximum
    a: np.ndarray        # [S] int64, its first argmax cell r * W + c
    o_i: np.ndarray      # [S] int64 band origins
    o_j: np.ndarray


def _pick(model, st: dict, res: BandedMaxima, slack: int, L: int, anchor, local: bool
          ) -> Optional[CykAlignment]:
    """The host pick from the per-state block maxima and their first argmax
    cells (flat ``r * W + c``): the best begin, its window coordinates, and
    the model span with the truncation clamp."""
    Sn = model.n_states
    m, a, o_i, o_j = res
    W = 2 * slack + 2
    lc = st["lc"]
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


def cyk_banded_maxima_plain(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
    device=None,
) -> BandedMaxima:
    """The plain version's DP: a Python loop of tensor steps over the
    states on ``device``; returns the block maxima, argmax cells and band
    origins."""
    dev = resolve_device(device)
    window = np.asarray(window)
    L = len(window)
    W = 2 * slack + 2
    st = _model_static(model, local, dev)
    lc = st["lc"]
    Sn = model.n_states
    o_i, o_j = _origins(st, L, anchor, slack)

    f32 = torch.float32
    wpad_t = torch.from_numpy(_padded_codes(window, W)).to(dev)
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
    return BandedMaxima(m, a, o_i, o_j)


def cyk_banded_plain(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
    device=None,
) -> Optional[CykAlignment]:
    """The plain version of :func:`cyk_banded_device` on ``device``: eager
    tensor steps, one state at a time. CPU calls take it; on a card it is
    the yardstick the kernel is held against."""
    dev = resolve_device(device)
    window = np.asarray(window)
    return _pick(model, _model_static(model, local, dev),
                 cyk_banded_maxima_plain(model, window, anchor, slack, local, dev),
                 slack, len(window), anchor, local)


class KernelInputs(NamedTuple):
    """What one launch of the kernel of ``csrc/cyk.cu`` reads."""
    step_table: torch.Tensor   # [n_scan, STEP_WORDS] int32, on the device
    order: torch.Tensor        # [n_scan] int32 step rows in dispatch order (_schedule)
    depth: int                 # the schedule's depth, in states
    e_states: torch.Tensor     # [n_E] int32
    single5: torch.Tensor      # [S, 5] float32
    pair5: torch.Tensor        # [S, 25] float32
    geo: torch.Tensor          # [2 S + L + W + 2] int32: o_i, o_j, padded codes
    n_states: int
    L: int
    W: int
    el_selfsc: float           # float32 value; 0.0 in glocal mode
    o_i: np.ndarray            # [S] int64 band origins, on the host
    o_j: np.ndarray


# A band wider than the kernel takes raises KernelLimitError. Not a
# ValueError: the rRNA search keeps the p7 hit on the band check's ValueError
# (a degenerate anchor), and a width the card cannot run must fail, not
# change the hit.


def check_kernel_width(slack: int) -> int:
    """The band width W = 2 * slack + 2; ValueError for a negative slack
    (a bad argument on every path), KernelLimitError for a width over the
    kernel's KERNEL_MAX_W."""
    W = 2 * slack + 2
    if slack < 0:
        raise ValueError(f"cyk_banded_device: negative slack {slack}")
    if W > KERNEL_MAX_W:
        raise KernelLimitError(
            f"cyk_banded_device: band width {W} (slack {slack}) over the kernel's limit of "
            f"{KERNEL_MAX_W} (slack at most {(KERNEL_MAX_W - 2) // 2}); the CPU path takes "
            f"any slack")
    return W


def kernel_inputs(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
    device=None,
) -> KernelInputs:
    """The kernel's inputs for one call on ``device``: the model's cached
    tables and this call's origins and codes, copied over in one transfer.
    Raises as :func:`check_kernel_width` and the band check do."""
    dev = resolve_device(device)
    W = check_kernel_width(slack)
    window = np.asarray(window)
    L = len(window)
    st = _model_static(model, local, dev)
    o_i, o_j = _origins(st, L, anchor, slack)
    if "step_table" not in st:          # built at the first kernel call of a model
        table = _step_table(st["steps"])
        order, st["depth"] = _schedule(table, model.n_states)
        st["step_table"] = torch.from_numpy(table).to(dev)
        st["order"] = torch.from_numpy(order).to(dev)
    geo = np.concatenate([o_i, o_j, _padded_codes(window, W)]).astype(np.int32)
    el = float(np.float32(st["lc"].el_selfsc)) if local else 0.0
    return KernelInputs(st["step_table"], st["order"], st["depth"], st["e_states"],
                        st["single5"], st["pair5"], torch.from_numpy(geo).to(dev),
                        model.n_states, L, W, el, o_i, o_j)


def _sync_buffer(dev: torch.device, n_states: int) -> Tuple[torch.Tensor, int]:
    """The kernel's sync buffer on ``dev`` for the current stream and this
    call's epoch. The buffer holds the work and done counters, which the
    kernel's last block sets back to 0, then a ready flag a state, which a
    state's block sets to the epoch of the call: it is zeroed once, when it
    is made (or outgrown), and every call takes the next epoch, so no call
    clears it and a call stays one launch. Calls on one stream run in turn;
    two streams get two buffers."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    hit = _SYNC.get(key)
    if hit is None or hit[0].numel() < 2 + n_states or hit[1] >= 2**31 - 1:
        n = max(_SYNC_MIN_STATES, 2 * n_states)
        hit = [torch.zeros(2 + n, dtype=torch.int32, device=dev), 0]
        _SYNC[key] = hit
    hit[1] += 1
    return hit[0], hit[1]


def cyk_banded_maxima(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
    device=None,
) -> BandedMaxima:
    """The block maxima, argmax cells and origins of one banded CYK: on a
    card one launch of the kernel of ``csrc/cyk.cu`` (deck, maxima and
    argmax cells in buffers allocated here; one copy back), on the CPU
    :func:`cyk_banded_maxima_plain`. Any other device raises ValueError."""
    dev = resolve_device(device)        # the CPU or a card; raises on any other
    if dev.type == "cpu":
        return cyk_banded_maxima_plain(model, window, anchor, slack, local, dev)
    x = kernel_inputs(model, window, anchor, slack, local, dev)
    dev = x.geo.device          # with its index, as kernels.launch wants it
    S, W = x.n_states, x.W
    deck = torch.empty((S, W, W), dtype=torch.float32, device=dev)
    out = torch.empty((2, S), dtype=torch.int32, device=dev)
    sync, epoch = _sync_buffer(dev, S)
    err = kernels.launch(
        dev, kernels.library().mfx_cyk_banded, x.step_table.data_ptr(),
        x.step_table.shape[0], x.order.data_ptr(), x.e_states.data_ptr(),
        x.e_states.shape[0], x.single5.data_ptr(), x.pair5.data_ptr(), x.geo.data_ptr(), S,
        x.L, W, x.el_selfsc, deck.data_ptr(), out.data_ptr(), sync.data_ptr(), epoch)
    if err:
        kernels.check(err, "cyk_banded_device")
    cyk_banded_device.launches += 1
    host = out.cpu().numpy()
    return BandedMaxima(host[0].view(np.float32), host[1].astype(np.int64), x.o_i, x.o_j)


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
    kernel's bands: score(numpy banded) <= score(this) <= score(exact).
    On a card: one launch of the kernel of ``csrc/cyk.cu`` (slack at most
    ``(KERNEL_MAX_W - 2) // 2``, else KernelLimitError); on the CPU: the
    plain version's DP, as
    :func:`cyk_banded_plain`; any other device raises ValueError."""
    dev = resolve_device(device)
    window = np.asarray(window)
    return _pick(model, _model_static(model, local, dev),
                 cyk_banded_maxima(model, window, anchor, slack, local, dev),
                 slack, len(window), anchor, local)


# kernel launches since the last reset (a plain counter, never reset here)
cyk_banded_device.launches = 0
