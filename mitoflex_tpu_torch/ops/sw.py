"""Batched affine-gap local alignment (Smith-Waterman) on tensors.

Port of mitoflex_tpu/ops/sw.py (``sw_align``, ``nucleotide_matrix``): row
i of the queries is aligned with row i of the targets; the best local score
comes back with its envelope (query and target from/to) and the identity,
column, gap-open and gap-column counts of its path, all carried through the
forward pass. The recurrences and every tie rule are the reference's:

    E[t,j] = max(H[t-1,j] - open, E[t-1,j] - ext)            (open wins ties)
    H'[t,j] = max(max(H[t-1,j-1], 0) + s(q_j, x_t), E[t,j])   (diagonal wins ties)
    F[t,j] = max_{i<j}(H'[t,i] + ext * i) - ext * j - (open - ext)
    H[t,j] = max(F if F > H' else H', 0)

On a card a call is one launch of the hand-written kernel of
``csrc/sw.cu`` for the whole batch, bit-equal to the plain version
``sw_align_plain`` (with integer substitution scores and gap costs, which
is all the pipeline uses), which CPU tensors take. In the plain version the
reference's ``lax.scan`` over target positions is a Python loop of tensor
steps. Substitution scores are an index gather (the reference's one-hot
einsum sums one non-zero term). The F closure is an inclusive prefix max
with the leftmost maximum on ties, the result of the reference's
associative scan; it carries the column of each maximum and gathers the
path counts from it. The six integer path fields ride as one [6, B, Lq]
tensor, so a step is a few dozen tensor operations whatever the widths.

Steps past every row's target length, and columns past every row's query
length, change no result (their cells are masked to 0), so the plain
version runs ``max(t_lens)`` steps over ``max(q_lens)`` columns and the
kernel stops each row at its own lengths.

``sw_scores`` gives the score alone, of pairs that share a few queries
and whose targets lie end to end: on a card one launch of the score-only
kernel of ``csrc/sw_score.cu`` for every pair, its plain version
``sw_scores_plain`` (the same loop without the path fields) on the CPU.
blastn scores every pair with it and traces paths only where a row passes
its e-value cut.

Gap convention: a gap of length g costs gap_open + (g-1)*gap_extend.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from . import row_pipeline
from .row_pipeline import PipelineConfig

NEG = -1e30

# rows of the path-field tensor
_QS, _TS, _ID, _NC, _GO, _GC = range(6)


class SwHits(NamedTuple):
    score: torch.Tensor      # [B] float32
    q_from: torch.Tensor     # [B] int32 0-based inclusive
    q_to: torch.Tensor
    t_from: torch.Tensor
    t_to: torch.Tensor
    n_ident: torch.Tensor    # [B] identical positions on the best path
    n_cols: torch.Tensor     # [B] aligned columns (match/mismatch + gaps)
    n_gapopen: torch.Tensor  # [B] gap openings on the best path
    n_gapcols: torch.Tensor  # [B] gapped columns


def nucleotide_matrix(match: int = 2, mismatch: int = -3) -> np.ndarray:
    """5x5 (ACGTN) scoring matrix; N scores mismatch against everything."""
    m = np.full((5, 5), mismatch, dtype=np.int32)
    np.fill_diagonal(m, match)
    m[4, :] = mismatch
    m[:, 4] = mismatch
    return m


def prefix_argmax(a: torch.Tensor):
    """Inclusive prefix maximum along the last axis and, per position, the
    index of the leftmost maximum of its prefix (Hillis-Steele doubling; the
    ties take the earlier column as the reference's combine does)."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device).expand(a.shape).contiguous()
    cm = a
    shift = 1
    while shift < n:
        left = cm[..., :-shift]
        take_l = left >= cm[..., shift:]
        cm = torch.cat([cm[..., :shift], torch.where(take_l, left, cm[..., shift:])], -1)
        idx = torch.cat([idx[..., :shift],
                         torch.where(take_l, idx[..., :-shift], idx[..., shift:])], -1)
        shift *= 2
    return cm, idx


def _shr(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted one column right along the last axis, ``fill`` entering."""
    return F.pad(x[..., :-1], (1, 0), value=fill)


def sw_align_plain(
    queries: torch.Tensor,   # [B, Lq] int8 symbol codes
    q_lens: torch.Tensor,    # [B]
    targets: torch.Tensor,   # [B, Lt] int8
    t_lens: torch.Tensor,    # [B]
    submat,                  # [K, K] substitution scores (array or tensor)
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
) -> SwHits:
    dev = queries.device
    B = queries.shape[0]
    q_lens = q_lens.to(device=dev, dtype=torch.int64)
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    Lq = max(int(q_lens.max()) if B else 0, 1)
    Lt = int(t_lens.max()) if B else 0
    queries = queries[:, :Lq]
    sub = torch.as_tensor(submat, dtype=torch.float32, device=dev)
    K = sub.shape[0]
    i32 = torch.int32
    jcol = torch.arange(Lq, device=dev, dtype=i32).expand(B, Lq)
    q_in = jcol < q_lens[:, None]
    qc = queries.to(torch.int64).clamp(0, K - 1)
    spre = sub[qc]                                   # [B, Lq, K]
    ext_ramp = gap_extend * jcol.to(torch.float32)
    first_col = jcol == 0
    zeros = torch.zeros((B, Lq), dtype=i32, device=dev)
    # path fields entering where a fresh local alignment starts: (query
    # start, target start, ident, cols, gap opens, gap cols)
    fresh_p = torch.stack([jcol, zeros, zeros, zeros, zeros, zeros])
    inc_e = torch.tensor([0, 0, 0, 1, 0, 1], dtype=i32, device=dev)[:, None, None]

    H = torch.zeros((B, Lq), device=dev)
    E = torch.full((B, Lq), NEG, device=dev)
    H_p = torch.zeros((6, B, Lq), dtype=i32, device=dev)
    E_p = torch.zeros_like(H_p)
    bV = torch.zeros((B, Lq), device=dev)
    bV_p = torch.zeros_like(H_p)
    bV_t = zeros.clone()
    tcodes = targets.to(torch.int64)
    for t in range(Lt):
        x = tcodes[:, t]
        s = torch.gather(spre, 2, x.clamp(0, K - 1)[:, None, None].expand(B, Lq, 1))[..., 0]
        valid = q_in & (t < t_lens)[:, None]
        s = torch.where(valid, s, NEG)
        is_match = (valid & (qc == x[:, None])).to(i32)

        # E: gap along the target (stay at the query column)
        e_open = H - gap_open
        e_ext = E - gap_extend
        take_open = e_open >= e_ext
        E = torch.where(take_open, e_open, e_ext)
        E_p = torch.where(take_open, H_p, E_p) + inc_e
        E_p[_GO] += take_open.to(i32)

        # diagonal: a fresh start is a diagonal move from score 0
        dH = _shr(H, 0.0)
        fresh = first_col | (dH <= 0.0)
        fresh_p[_TS] = t
        d_p = torch.where(fresh, fresh_p, _shr(H_p, 0))
        diag = torch.where(first_col, 0.0, dH).clamp(min=0.0)
        cand_d = diag + s
        d_p[_ID] += is_match
        d_p[_NC] += 1

        use_d = cand_d >= E
        Hp = torch.where(use_d, cand_d, E)
        Hp_p = torch.where(use_d, d_p, E_p)

        # F: gap along the query, closed by a prefix max of Hp + ext * j
        # whose argmax column gives the exact gap length
        cm, col = prefix_argmax(Hp + ext_ramp)
        Fv = _shr(cm, NEG) - ext_ramp - (gap_open - gap_extend)
        F_p = _shr(torch.gather(Hp_p, 2, col.expand(6, B, Lq)), 0)
        gap_len = jcol - _shr(col.to(i32), 0)
        F_p[_NC] += gap_len
        F_p[_GC] += gap_len
        F_p[_GO] += 1

        use_f = Fv > Hp
        H = torch.where(valid, torch.where(use_f, Fv, Hp).clamp(min=0.0), 0.0)
        H_p = torch.where(use_f, F_p, Hp_p)

        better = H > bV
        bV = torch.where(better, H, bV)
        bV_p = torch.where(better, H_p, bV_p)
        bV_t = torch.where(better, t, bV_t)

    endj = torch.argmax(bV, dim=1)[:, None]  # the first maximum

    def pick(v):
        return torch.gather(v, 1, endj)[:, 0]

    return SwHits(
        score=pick(bV), q_from=pick(bV_p[_QS]), q_to=endj[:, 0].to(i32),
        t_from=pick(bV_p[_TS]), t_to=pick(bV_t),
        n_ident=pick(bV_p[_ID]), n_cols=pick(bV_p[_NC]),
        n_gapopen=pick(bV_p[_GO]), n_gapcols=pick(bV_p[_GC]),
    )


# fields of the kernel's [9, B] int32 output, in SwHits order (the score as
# float32 bits)
_OUT_ROWS = len(SwHits._fields)

# The kernel's layouts are ops/row_pipeline.py's (csrc/row_pipeline.cuh,
# shared with csrc/genewise.cu). The packed path fields (qs | ts << 16,
# id | nc << 16, go | gc << 16) hold while Lq + Lt is at most this; a longer
# row takes the wide instantiation
KERNEL_PACK_LIMIT = 65535
# 32-bit words a lane hands right a step for each of its positions: F
# leaving its last column and that column's H, each a value and 3 packed (6
# wide) path words
SLOT_WORDS = {False: 8, True: 14}
# the chooser's model of a stage step's time at (cols, rows), a step at one
# column and one position a lane being 1: a lone warp's step is mostly its
# hand-offs and fetches, so more columns or positions add little (measured
# on an H100, PERF.md)
STEP_COST = {(1, 1): 1.0, (2, 1): 1.08, (4, 1): 1.3, (1, 2): 1.52, (2, 2): 1.8}


def sw_packable(Lq: int, Lt: int) -> bool:
    """Whether the packed path fields hold at these widths."""
    return Lq + Lt <= KERNEL_PACK_LIMIT


def sw_smem_bytes(cfg: PipelineConfig, K: int) -> int:
    return row_pipeline.smem_bytes(cfg, K, False, row_pipeline.slot_words(cfg, SLOT_WORDS))


def check_config(cfg: PipelineConfig, Lq: int, Lt: int, K: int) -> None:
    row_pipeline.check_config(cfg, Lq, Lt, K, False, row_pipeline.slot_words(cfg, SLOT_WORDS),
                              sw_packable(Lq, Lt), "sw_align")


def sw_config(Lq: int, Lt: int) -> PipelineConfig:
    """The kernel's layout for pairs of padded widths ``Lq`` and ``Lt``
    (``row_pipeline.choose`` at STEP_COST); wide path fields where Lq + Lt
    exceeds KERNEL_PACK_LIMIT."""
    return row_pipeline.choose(Lq, Lt, not sw_packable(Lq, Lt), STEP_COST, "sw_align")


def sw_configs(Lq: int, Lt: int) -> list:
    """Every layout ``sw_config`` weighs at these widths, one an
    instantiation (its pick among them)."""
    return row_pipeline.layouts(Lq, Lt, not sw_packable(Lq, Lt))


def sw_align(
    queries: torch.Tensor,   # [B, Lq] int8 symbol codes
    q_lens: torch.Tensor,    # [B] integer
    targets: torch.Tensor,   # [B, Lt] int8
    t_lens: torch.Tensor,    # [B] integer
    submat,                  # [K, K] substitution scores (array or tensor)
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
    *,
    _config=None,
) -> SwHits:
    """Best local alignment of query row i with target row i, with its
    envelope and path counts. Tensors on a card: one launch of the kernel
    of ``csrc/sw.cu`` for the whole batch (each row stops at its own
    lengths; no host sync; layout from ``sw_config``, ``_config`` forces one
    for the kernel's checks); on the CPU: :func:`sw_align_plain`."""
    dev = queries.device
    if dev.type == "cpu":
        return sw_align_plain(queries, q_lens, targets, t_lens, submat, gap_open,
                              gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"sw_align: unsupported device {dev}")
    q_lens, t_lens, sub = row_pipeline.check_inputs(queries, q_lens, targets, t_lens, submat,
                                                    "sw_align")
    B, Lq = queries.shape
    Lt = targets.shape[1]
    out = torch.empty((_OUT_ROWS, B), dtype=torch.int32, device=dev)
    if B:
        K = sub.shape[0]
        if _config is None:
            cfg = sw_config(Lq, Lt)
        else:
            cfg = PipelineConfig(*_config)
            check_config(cfg, Lq, Lt, K)
        scratch = row_pipeline.scratch(cfg, B, Lq, Lt, SLOT_WORDS, dev)
        err = kernels.launch(
            dev, kernels.library().mfx_sw_align, queries.data_ptr(), q_lens.data_ptr(),
            targets.data_ptr(), t_lens.data_ptr(), sub.data_ptr(), K, B, Lq, Lt,
            float(gap_open), float(gap_extend), cfg.cols, cfg.warps, cfg.cluster,
            int(cfg.wide), cfg.rows, None if scratch is None else scratch.data_ptr(),
            out.data_ptr())
        if err:
            kernels.check(err, "sw_align")
        sw_align.launches += 1
    return SwHits(out[0].view(torch.float32), *out[1:])


# kernel launches since the last reset (a plain counter, never reset here)
sw_align.launches = 0


# --------------------------------------------------------------- score only
# the score kernel's (csrc/sw_score.cu) limits: letters of a table; the
# bound on |entries|, gap costs and scores (float32 holds every integer
# below it, so a score is sw_align's bit for bit); warps a block; and the
# scratch a call may take (the grid shrinks to stay under it)
SCORE_MAX_K = 32
SCORE_LIMIT = 1 << 24
SCORE_WARPS = 8
SCORE_SCRATCH_BYTES = 1 << 30
# int32 operations a cell (the kernel's note): its bound's numerator
SCORE_OPS_PER_CELL = 10


def _score_batch(q, ql, t, tl, sub, gap_open, gap_extend) -> torch.Tensor:
    """``sw_align_plain``'s recurrence on padded rows without the path
    fields: each row's best H, the same float32 values."""
    dev = q.device
    B = q.shape[0]
    Lq = max(int(ql.max()) if B else 0, 1)
    Lt = int(tl.max()) if B else 0
    K = sub.shape[0]
    jcol = torch.arange(Lq, device=dev)
    q_in = jcol < ql[:, None]
    spre = sub[q[:, :Lq].to(torch.int64).clamp(0, K - 1)]      # [B, Lq, K]
    ext_ramp = gap_extend * jcol.to(torch.int32).to(torch.float32)
    H = torch.zeros((B, Lq), device=dev)
    E = torch.full((B, Lq), NEG, device=dev)
    best = torch.zeros((B, Lq), device=dev)
    tcodes = t.to(torch.int64).clamp(0, K - 1)
    for s in range(Lt):
        sc = torch.gather(spre, 2, tcodes[:, s][:, None, None].expand(B, Lq, 1))[..., 0]
        valid = q_in & (s < tl)[:, None]
        sc = torch.where(valid, sc, NEG)
        E = torch.maximum(H - gap_open, E - gap_extend)
        Hp = torch.maximum(_shr(H, 0.0) + sc, E)
        cm = torch.cummax(Hp + ext_ramp, -1).values
        Fv = _shr(cm, NEG) - ext_ramp - (gap_open - gap_extend)
        H = torch.where(valid, torch.maximum(Fv, Hp).clamp(min=0.0), 0.0)
        best = torch.maximum(best, H)
    return best.max(1).values


def sw_scores_plain(
    queries: torch.Tensor,    # [Q, Lq] int8 symbol codes
    q_lens: torch.Tensor,     # [Q]
    q_index: torch.Tensor,    # [B]: each pair's query
    targets: torch.Tensor,    # [T] int8: the pairs' targets end to end
    t_offsets: torch.Tensor,  # [B + 1]
    submat,
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
    batch: int = 64,
) -> torch.Tensor:
    """Best local score of pair b, query ``q_index[b]`` (its length
    ``q_lens`` clamped to [0, Lq]) against ``targets[t_offsets[b] :
    t_offsets[b + 1]]``: float32 [B], equal bit for bit to ``sw_align``'s
    ``score`` on the same rows. Pairs go ``batch`` at a time through
    ``sw_align_plain``'s loop over target positions, without its path
    fields. ValueError for an index or offset out of range."""
    dev = queries.device
    Q, Lq = queries.shape
    qi = [int(i) for i in q_index.tolist()]
    offs = [int(o) for o in t_offsets.tolist()]
    if len(offs) != len(qi) + 1 or any(not 0 <= i < Q for i in qi) \
            or any(b < a for a, b in zip(offs, offs[1:])) \
            or (offs and not 0 <= offs[0] <= offs[-1] <= targets.numel()):
        raise ValueError("sw_scores_plain: a query index or target offset out of range")
    sub = torch.as_tensor(submat, dtype=torch.float32, device=dev)
    ql_all = q_lens.to(device=dev, dtype=torch.int64).clamp(0, Lq)
    out = torch.zeros(len(qi), dtype=torch.float32, device=dev)
    for b0 in range(0, len(qi), batch):
        rows = range(b0, min(b0 + batch, len(qi)))
        idx = torch.tensor([qi[i] for i in rows], dtype=torch.int64, device=dev)
        tl = [offs[i + 1] - offs[i] for i in rows]
        t = torch.zeros((len(rows), max(max(tl), 1)), dtype=torch.int8, device=dev)
        for r, i in enumerate(rows):
            t[r, : tl[r]] = targets[offs[i]: offs[i + 1]]
        out[b0: b0 + len(rows)] = _score_batch(
            queries[idx], ql_all[idx], t, torch.tensor(tl, device=dev), sub, gap_open,
            gap_extend)
    return out


def score_inputs(queries: torch.Tensor, q_lens: torch.Tensor, q_index: torch.Tensor,
                 targets: torch.Tensor, t_offsets: torch.Tensor, submat, gap_open: float,
                 gap_extend: float) -> tuple:
    """The score kernel's arguments, or ValueError naming what it does not
    take: int8 queries [Q >= 1, Lq] and targets [T], integer q_lens [Q],
    q_index [B] and t_offsets [B + 1], all contiguous on one device; a
    symmetric [K, K] table of integers, K <= SCORE_MAX_K, read on the host
    (a card tensor is copied back); integer gap costs with 0 <= extend <=
    open; entries and costs below SCORE_LIMIT in magnitude, and the largest
    entry times Lq too, so that no score reaches it. Returns q_lens int32
    (clamped to [0, Lq]), q_index and t_offsets int64, the table as an
    int32 tensor there, the gap costs, and the compare form (flag, match,
    mismatch): the nucleotide table's shape, a match score on the diagonal
    but for the last letter and one negative score elsewhere."""
    dev = queries.device
    for name, x, dim in (("queries", queries, 2), ("targets", targets, 1)):
        if x.dim() != dim or x.dtype != torch.int8 or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"sw_scores: {name} must be a contiguous int8 tensor of "
                             f"{dim} dimensions on {dev}, got {x.dtype} {list(x.shape)} "
                             f"on {x.device}")
    Q, Lq = queries.shape
    if Q < 1:
        raise ValueError("sw_scores: no queries")
    B = q_index.shape[0] if q_index.dim() == 1 else -1
    ints = []
    for name, x, n in (("q_lens", q_lens, Q), ("q_index", q_index, B),
                       ("t_offsets", t_offsets, B + 1)):
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool \
                or x.dim() != 1 or x.shape[0] != n or x.device != dev:
            raise ValueError(f"sw_scores: {name} must be an integer tensor [{n}] on {dev}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
        ints.append(x)
    table = np.asarray(submat.cpu() if isinstance(submat, torch.Tensor) else submat,
                       dtype=np.float64)
    K = table.shape[0] if table.ndim == 2 else 0
    if table.ndim != 2 or table.shape[1] != K or not 1 <= K <= SCORE_MAX_K:
        raise ValueError(f"sw_scores: submat must be a square [K, K] matrix, K <= "
                         f"{SCORE_MAX_K}, got {list(table.shape)}")
    if not np.array_equal(table, table.T):
        raise ValueError("sw_scores: submat must be symmetric (the kernel picks which "
                         "side lies along its lanes)")
    costs = np.array([gap_open, gap_extend], np.float64)
    if not (np.array_equal(table, np.rint(table)) and np.array_equal(costs, np.rint(costs))):
        raise ValueError("sw_scores: submat and the gap costs must be integers")
    if not 0 <= gap_extend <= gap_open < SCORE_LIMIT:
        raise ValueError(f"sw_scores: gap costs must hold 0 <= extend <= open < "
                         f"{SCORE_LIMIT}, got open {gap_open}, extend {gap_extend}")
    if np.abs(table).max() >= SCORE_LIMIT or max(table.max(), 0) * Lq >= SCORE_LIMIT:
        raise ValueError(f"sw_scores: submat entries and the best possible score (the "
                         f"largest entry x Lq {Lq}) must stay below {SCORE_LIMIT}")
    diag = np.eye(K, dtype=bool)
    diag[K - 1, K - 1] = False
    match, mismatch = table[0, 0], table[K - 1, K - 1]
    compare = K > 1 and mismatch < 0 and np.array_equal(
        table, np.where(diag, match, mismatch))
    return (ints[0].to(torch.int32).clamp(0, Lq).contiguous(),
            ints[1].to(torch.int64).contiguous(), ints[2].to(torch.int64).contiguous(),
            torch.from_numpy(table.astype(np.int32)).to(dev), int(gap_open), int(gap_extend),
            (int(compare), int(match), int(mismatch)))


def _score_blocks(dev) -> int:
    """Blocks of the score kernel resident on card ``dev`` at once."""
    blocks = _score_blocks.cache.get(dev.index)
    if blocks is None:
        with torch.cuda.device(dev):
            blocks = kernels.library().mfx_sw_scores_blocks()
        if blocks < 1:
            raise RuntimeError("sw_scores: the card's occupancy query failed")
        _score_blocks.cache[dev.index] = blocks
    return blocks


_score_blocks.cache = {}


def sw_scores(
    queries: torch.Tensor,    # [Q, Lq] int8 symbol codes
    q_lens: torch.Tensor,     # [Q] integer
    q_index: torch.Tensor,    # [B] integer: each pair's query
    targets: torch.Tensor,    # [T] int8: the pairs' targets end to end
    t_offsets: torch.Tensor,  # [B + 1] integer
    submat,                   # [K, K] symmetric integer scores
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
) -> torch.Tensor:
    """Best local score of each pair: float32 [B], bit-equal to ``sw_align``'s
    ``score`` for query ``q_index[b]`` against ``targets[t_offsets[b] :
    t_offsets[b + 1]]``. Tensors on a card: the arguments checked
    (:func:`score_inputs`), then one launch of the kernel of
    ``csrc/sw_score.cu`` for every pair, most cells first; no host sync; a
    pair whose query index or offsets are out of range scores NaN. On the
    CPU: :func:`sw_scores_plain`."""
    dev = queries.device
    if dev.type == "cpu":
        return sw_scores_plain(queries, q_lens, q_index, targets, t_offsets, submat,
                               gap_open, gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"sw_scores: unsupported device {dev}")
    ql, qi, offs, sub, go, ge, (cmp, match, mismatch) = score_inputs(
        queries, q_lens, q_index, targets, t_offsets, submat, gap_open, gap_extend)
    Q, Lq = queries.shape
    B = qi.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        cells = ql[qi.clamp(0, Q - 1)].to(torch.int64) * (offs[1:] - offs[:-1]).clamp(min=0)
        order = torch.argsort(cells, descending=True, stable=True)
        blocks = min(_score_blocks(dev), -(-B // SCORE_WARPS),
                     max(1, SCORE_SCRATCH_BYTES // (SCORE_WARPS * max(Lq, 1) * 8)))
        scratch = torch.empty((blocks * SCORE_WARPS, Lq, 2), dtype=torch.int32, device=dev)
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        err = kernels.launch(
            dev, kernels.library().mfx_sw_scores, queries.data_ptr(), ql.data_ptr(),
            qi.data_ptr(), targets.data_ptr(), offs.data_ptr(), order.data_ptr(),
            sub.data_ptr(), sub.shape[0], Q, B, Lq, targets.numel(), go, ge, cmp, match,
            mismatch, scratch.data_ptr(), blocks, nxt.data_ptr(), out.data_ptr())
        if err:
            kernels.check(err, "sw_scores")
        sw_scores.launches += 1
    return out


# kernel launches since the last reset (a plain counter, never reset here)
sw_scores.launches = 0
