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
# columns of one strip of the kernel (csrc/sw.cu kStrip); a query longer
# than that carries each target position's state across strips through a
# [B, Lt, 14] int32 scratch tensor
KERNEL_STRIP = 128
_BOUNDARY_WORDS = 14


def _check_inputs(queries: torch.Tensor, q_lens: torch.Tensor, targets: torch.Tensor,
                  t_lens: torch.Tensor, submat, what: str = "sw_align",
                  targets_name: str = "targets") -> tuple:
    """The lengths as int32 and the matrix as a float32 tensor on the
    queries' device; ValueError naming ``what`` unless its kernel takes
    these arguments: int8 queries [B, Lq] and targets [B, Lt], integer
    lengths [B], a square matrix, all contiguous on one device. Lengths of
    another integer type, and a matrix in another type, are converted there;
    a matrix given as an array is converted on the host, so that a call
    launches no kernel but its own."""
    dev = queries.device
    for name, x in (("queries", queries), (targets_name, targets)):
        if x.dim() != 2 or x.dtype != torch.int8 or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"{what}: {name} must be a contiguous int8 tensor [B, L] "
                             f"on {dev}, got {x.dtype} {list(x.shape)} on {x.device}")
    B = queries.shape[0]
    if targets.shape[0] != B:
        raise ValueError(f"{what}: {B} queries but {targets.shape[0]} targets")
    lens = []
    for name, x in (("q_lens", q_lens), ("t_lens", t_lens)):
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool \
                or tuple(x.shape) != (B,) or x.device != dev:
            raise ValueError(f"{what}: {name} must be an integer tensor [{B}] on {dev}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
        lens.append(x.to(torch.int32).contiguous())
    sub = submat if isinstance(submat, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(submat, dtype=np.float32)).to(dev)
    if sub.device != dev or sub.dim() != 2 or sub.shape[0] != sub.shape[1] \
            or sub.shape[0] < 1:
        raise ValueError(f"{what}: submat must be a square [K, K] matrix on {dev}, got "
                         f"{list(sub.shape)} on {sub.device}")
    return lens[0], lens[1], sub.to(torch.float32).contiguous()


def sw_align(
    queries: torch.Tensor,   # [B, Lq] int8 symbol codes
    q_lens: torch.Tensor,    # [B] integer
    targets: torch.Tensor,   # [B, Lt] int8
    t_lens: torch.Tensor,    # [B] integer
    submat,                  # [K, K] substitution scores (array or tensor)
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
) -> SwHits:
    """Best local alignment of query row i with target row i, with its
    envelope and path counts. Tensors on a card: one launch of the kernel
    of ``csrc/sw.cu`` for the whole batch (each row stops at its own
    lengths; no host sync); on the CPU: :func:`sw_align_plain`."""
    dev = queries.device
    if dev.type == "cpu":
        return sw_align_plain(queries, q_lens, targets, t_lens, submat, gap_open,
                              gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"sw_align: unsupported device {dev}")
    q_lens, t_lens, sub = _check_inputs(queries, q_lens, targets, t_lens, submat)
    B, Lq = queries.shape
    Lt = targets.shape[1]
    out = torch.empty((_OUT_ROWS, B), dtype=torch.int32, device=dev)
    if B:
        scratch = None
        if Lq > KERNEL_STRIP and Lt:
            scratch = torch.empty((B, Lt, _BOUNDARY_WORDS), dtype=torch.int32, device=dev)
        err = kernels.launch(
            dev, kernels.library().mfx_sw_align, queries.data_ptr(), q_lens.data_ptr(),
            targets.data_ptr(), t_lens.data_ptr(), sub.data_ptr(), sub.shape[0], B, Lq,
            Lt, float(gap_open), float(gap_extend),
            None if scratch is None else scratch.data_ptr(), out.data_ptr())
        if err:
            kernels.check(err, "sw_align")
        sw_align.launches += 1
    return SwHits(out[0].view(torch.float32), *out[1:])


# kernel launches since the last reset (a plain counter, never reset here)
sw_align.launches = 0
