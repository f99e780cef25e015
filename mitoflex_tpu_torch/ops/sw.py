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
