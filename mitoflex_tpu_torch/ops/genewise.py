"""Codon-aware protein-vs-DNA alignment with frameshifts (genewise
equivalent) on tensors.

Port of mitoflex_tpu/ops/genewise.py (``translate_windows``,
``genewise_align``). Mito genes have no introns, so what the pipeline uses
genewise for is frameshift-tolerant refinement of the washed blast hits and
the derived columns ``wise_cover``, ``wise_shift``, ``wise_min_start`` and
``wise_max_end``. All hits go through one batched call. The DP runs over DNA
positions t with state vectors [hits, protein_len]:

    H[t,j] = s(q_j, aa(t-2..t)) + max(0,
             H[t-3,j-1],                         codon match
             H[t-dt,j-1] - fs_pen  (dt=1,2,4,5)  frameshift
             E[t-3,j-1], F[t,j])                 codon / residue gaps
    E[t,j] = max(H[t-3,j] - open, E[t-3,j] - ext)    gap in protein axis
    F      = prefix maximum along j                  gap in DNA axis

The frameshift count and the alignment's envelope are carried through the
forward pass; in-frame stops score ``-stop_penalty``. Every tie rule is the
reference's: a candidate replaces the running best only when strictly
greater, in the order start, dt = 3, 1, 2, 4, 5, E; ``open`` wins ties in E;
the prefix maximum keeps the left element on ties (``sw.prefix_argmax``);
the end column is the first maximum.

On a card a call is one launch of the hand-written kernel of
``csrc/genewise.cu`` for every hit, bit-equal to the plain version
``genewise_align_plain`` (with integer substitution scores and penalties,
which is all the pipeline uses), which CPU tensors take. In the plain
version the reference's ``lax.scan`` over the T target positions is a
Python loop of tensor steps. The last five rows of H (three of E) live in
preallocated ring buffers that carry one extra leading column holding the
shift's fill value, so "row t-dt shifted right along j" is a view and a
step assigns slices instead of concatenating. The substitution score is an index gather (the
reference's one-hot matvec sums one non-zero term). The three integer path
fields (query start, target start, frameshifts) ride as one [3, B, Lq]
tensor.

Steps past every row's target length and columns past every row's query
length change no result (their cells are masked), so the plain version runs
``max(t_lens)`` steps over ``max(q_lens)`` columns and the kernel stops
each row at its own lengths.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..models import codon
from . import row_pipeline
from .row_pipeline import PipelineConfig
from .sw import prefix_argmax

NEG = -1e30

# rows of the path-field tensor
_QS, _TS, _SH = range(3)


class WiseHits(NamedTuple):
    score: torch.Tensor     # [B] float32
    q_from: torch.Tensor    # [B] 0-based aa coords
    q_to: torch.Tensor
    t_from: torch.Tensor    # [B] 0-based nt coords (start of first codon)
    t_to: torch.Tensor      # [B] (end of last codon, inclusive)
    n_shift: torch.Tensor   # [B] frameshifts on best path


def translate_windows(windows: np.ndarray, table_id: int) -> np.ndarray:
    """aa code of the codon ENDING at each position t (t >= 2), else X.
    windows: [B, T] base codes."""
    gc = codon.get_code(table_id)
    B, T = windows.shape
    out = np.full((B, T), codon.X_CODE, dtype=np.int8)
    if T < 3:
        return out
    c0 = windows[:, : T - 2].astype(np.int32)
    c1 = windows[:, 1 : T - 1].astype(np.int32)
    c2 = windows[:, 2:].astype(np.int32)
    bad = (c0 >= 4) | (c1 >= 4) | (c2 >= 4)
    idx = c0 * 16 + c1 * 4 + c2
    aa = gc.aa_lut[np.where(bad, 0, idx)]
    aa[bad] = codon.X_CODE
    out[:, 2:] = aa
    return out


def genewise_align_plain(
    queries: torch.Tensor,    # [B, Lq] aa codes
    q_lens: torch.Tensor,     # [B]
    target_aa: torch.Tensor,  # [B, T] aa-of-codon-ending-at-t (int8)
    t_lens: torch.Tensor,     # [B] nt lengths
    submat,                   # [K, K] (array or tensor)
    gap_open: float = 13.0,
    gap_extend: float = 3.0,
    fs_penalty: float = 15.0,
    stop_penalty: float = 20.0,
) -> WiseHits:
    """Runs on the device of ``queries``; the other tensors must lie there
    too (``submat`` is moved)."""
    dev = queries.device
    B = queries.shape[0]
    i32 = torch.int32
    q_lens = q_lens.to(device=dev, dtype=torch.int64)
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    Lq = max(int(q_lens.max()) if B else 0, 1)
    T = min(int(t_lens.max()) if B else 0, target_aa.shape[1])
    queries = queries[:, :Lq]
    sub = torch.as_tensor(submat, dtype=torch.float32, device=dev)
    K = sub.shape[0]
    jcol = torch.arange(Lq, device=dev, dtype=i32).expand(B, Lq)
    q_in = jcol < q_lens[:, None]
    spre = sub[queries.to(torch.int64).clamp(0, K - 1)]      # [B, Lq, K]
    ext_ramp = gap_extend * jcol.to(torch.float32)
    open_minus_ext = gap_open - gap_extend

    # ring buffers, column 0 = the fill that a right shift brings in
    Hs = torch.full((5, B, Lq + 1), NEG, device=dev)
    Hs[:, :, 0] = 0.0
    Es = torch.full((3, B, Lq + 1), NEG, device=dev)
    Hp = torch.zeros((5, 3, B, Lq + 1), dtype=i32, device=dev)
    Ep = torch.zeros((3, 3, B, Lq + 1), dtype=i32, device=dev)
    # the prefix maximum and its fields, shifted right (fills NEG and 0)
    cm_sh = torch.full((B, Lq), NEG, device=dev)
    cp_sh = torch.zeros((3, B, Lq), dtype=i32, device=dev)
    bV = torch.zeros((B, Lq), device=dev)
    bP = torch.zeros((3, B, Lq), dtype=i32, device=dev)
    bT = torch.zeros((B, Lq), dtype=i32, device=dev)
    # fields of a fresh start at column j: (j, t - 2, 0)
    fresh = torch.zeros((3, B, Lq), dtype=i32, device=dev)
    fresh[_QS] = jcol
    zero_f = torch.zeros((B, Lq), device=dev)
    inc_sh = torch.tensor([0, 0, 1], dtype=i32, device=dev)[:, None, None]
    taa = target_aa.to(torch.int64)

    for t in range(T):
        aa = taa[:, t]
        s = torch.gather(spre, 2, aa.clamp(0, K - 1)[:, None, None]
                         .expand(B, Lq, 1))[..., 0]
        s = torch.where((aa == codon.STOP_CODE)[:, None], -stop_penalty, s)
        valid = q_in & (t < t_lens)[:, None]
        s = torch.where(valid, s, NEG)

        # candidates in the reference's order; a later one wins only when
        # strictly greater
        fresh[_TS] = max(t - 2, 0)
        arr = zero_f
        P = fresh
        for dt, pen in ((3, 0.0), (1, fs_penalty), (2, fs_penalty),
                        (4, fs_penalty), (5, fs_penalty)):
            slot = (t - dt) % 5
            h = Hs[slot, :, :Lq]                   # H[t-dt] shifted right
            # restarts are the 0 candidate's; early steps read the NEG fill
            cand = torch.where(h <= 0.0, NEG, h) - pen
            p = Hp[slot, :, :, :Lq]
            if dt != 3:
                p = p + inc_sh
            take = cand > arr
            P = torch.where(take, p, P)
            arr = torch.where(take, cand, arr)
        # E: a codon gap along the DNA axis. E[t] is built from t-3; a
        # codon match at t resumes from E[t-3] one query residue on.
        e_slot, h3_slot = t % 3, (t - 3) % 5
        e_prev = Es[e_slot, :, 1:]
        e_open = Hs[h3_slot, :, 1:] - gap_open
        e_ext = e_prev - gap_extend
        take_open = e_open >= e_ext
        E_new = torch.where(take_open, e_open, e_ext)
        Ep_new = torch.where(take_open, Hp[h3_slot, :, :, 1:], Ep[e_slot, :, :, 1:])
        cand = Es[e_slot, :, :Lq]
        take = cand > arr
        P = torch.where(take, Ep[e_slot, :, :, :Lq], P)
        arr = torch.where(take, cand, arr)
        Hc = s + arr

        # F: protein gap (skip query residues, no DNA): prefix maximum of
        # Hc + ext * j, the leftmost on ties
        cm, col = prefix_argmax(Hc + ext_ramp)
        cm_sh[:, 1:] = cm[:, :-1]
        cp_sh[:, :, 1:] = torch.gather(P, 2, col.expand(3, B, Lq))[:, :, :-1]
        Fv = cm_sh - ext_ramp - open_minus_ext
        use_f = Fv > Hc
        H = torch.where(use_f, Fv, Hc)
        P = torch.where(use_f, cp_sh, P)
        H = torch.where(valid, H.clamp(min=NEG), NEG)

        better = H > bV
        bV = torch.where(better, H, bV)
        bP = torch.where(better, P, bP)
        bT = torch.where(better, t, bT)

        Es[e_slot, :, 1:] = E_new
        Ep[e_slot, :, :, 1:] = Ep_new
        w = t % 5
        Hs[w, :, 1:] = H
        Hp[w, :, :, 1:] = P

    endj = torch.argmax(bV, dim=1)[:, None]  # the first maximum

    def pick(v):
        return torch.gather(v, 1, endj)[:, 0]

    return WiseHits(
        score=pick(bV), q_from=pick(bP[_QS]), q_to=endj[:, 0].to(i32),
        t_from=pick(bP[_TS]), t_to=pick(bT), n_shift=pick(bP[_SH]),
    )


# fields of the kernel's [6, B] int32 output, in WiseHits order (the score
# as float32 bits)
_OUT_ROWS = len(WiseHits._fields)
# 32-bit words a lane hands right a step for each of its bases
# (csrc/genewise.cu): the F leaving its last column and that column's H and
# E, each a value and 2 packed (3 wide) path words
SLOT_WORDS = {False: 9, True: 12}
# the packed path fields (qs | ts << 16, shifts) hold while Lq and T are
# each at most this; longer rows take the wide instantiation
KERNEL_PACK_LIMIT = 65535
# the chooser's model of a stage step's time at (cols, rows) (a step at one
# column and one base a lane being 1): a column reads six cells of history,
# so more cells cost more than in the Smith-Waterman (measured on an H100,
# PERF.md)
STEP_COST = {(1, 1): 1.0, (2, 1): 1.25, (4, 1): 1.8, (1, 2): 1.3, (2, 2): 1.75}


def genewise_packable(Lq: int, T: int) -> bool:
    """Whether the packed path fields hold at these widths."""
    return Lq <= KERNEL_PACK_LIMIT and T <= KERNEL_PACK_LIMIT


def genewise_smem_bytes(cfg: PipelineConfig, K: int) -> int:
    return row_pipeline.smem_bytes(cfg, K, True, row_pipeline.slot_words(cfg, SLOT_WORDS))


def check_config(cfg: PipelineConfig, Lq: int, T: int, K: int) -> None:
    row_pipeline.check_config(cfg, Lq, T, K, True, row_pipeline.slot_words(cfg, SLOT_WORDS),
                              genewise_packable(Lq, T), "genewise_align")


def genewise_config(Lq: int, T: int) -> PipelineConfig:
    """The kernel's layout for hits of padded widths ``Lq`` and ``T``
    (``row_pipeline.choose`` at STEP_COST, the same pipeline as the
    Smith-Waterman kernel's); wide path fields where Lq or T exceeds
    KERNEL_PACK_LIMIT."""
    return row_pipeline.choose(Lq, T, not genewise_packable(Lq, T), STEP_COST,
                               "genewise_align")


def genewise_configs(Lq: int, T: int) -> list:
    """Every layout ``genewise_config`` weighs at these widths, one an
    instantiation (its pick among them)."""
    return row_pipeline.layouts(Lq, T, not genewise_packable(Lq, T))


def genewise_align(
    queries: torch.Tensor,    # [B, Lq] int8 aa codes
    q_lens: torch.Tensor,     # [B] integer
    target_aa: torch.Tensor,  # [B, T] int8 aa-of-codon-ending-at-t
    t_lens: torch.Tensor,     # [B] integer nt lengths
    submat,                   # [K, K] (array or tensor)
    gap_open: float = 13.0,
    gap_extend: float = 3.0,
    fs_penalty: float = 15.0,
    stop_penalty: float = 20.0,
    *,
    _config=None,
) -> WiseHits:
    """Best frameshift-tolerant local alignment of query row i with the
    translated target row i, with its envelope and frameshift count.
    Tensors on a card: one launch of the kernel of ``csrc/genewise.cu`` for
    every hit (each row stops at its own lengths; no host sync; layout from
    ``genewise_config``, ``_config`` forces one for the kernel's checks); on
    the CPU: :func:`genewise_align_plain`."""
    dev = queries.device
    if dev.type == "cpu":
        return genewise_align_plain(queries, q_lens, target_aa, t_lens, submat, gap_open,
                                    gap_extend, fs_penalty, stop_penalty)
    if dev.type != "cuda":
        raise ValueError(f"genewise_align: unsupported device {dev}")
    q_lens, t_lens, sub = row_pipeline.check_inputs(queries, q_lens, target_aa, t_lens,
                                                    submat, "genewise_align", "target_aa")
    B, Lq = queries.shape
    T = target_aa.shape[1]
    out = torch.empty((_OUT_ROWS, B), dtype=torch.int32, device=dev)
    if B:
        K = sub.shape[0]
        if _config is None:
            cfg = genewise_config(Lq, T)
        else:
            cfg = PipelineConfig(*_config)
            check_config(cfg, Lq, T, K)
        scratch = row_pipeline.scratch(cfg, B, Lq, T, SLOT_WORDS, dev)
        err = kernels.launch(
            dev, kernels.library().mfx_genewise_align, queries.data_ptr(),
            q_lens.data_ptr(), target_aa.data_ptr(), t_lens.data_ptr(), sub.data_ptr(),
            K, B, Lq, T, codon.STOP_CODE, float(gap_open), float(gap_extend),
            float(fs_penalty), float(stop_penalty), cfg.cols, cfg.warps, cfg.cluster,
            int(cfg.wide), cfg.rows, None if scratch is None else scratch.data_ptr(),
            out.data_ptr())
        if err:
            kernels.check(err, "genewise_align")
        genewise_align.launches += 1
    return WiseHits(out[0].view(torch.float32), *out[1:])


# kernel launches since the last reset (a plain counter, never reset here)
genewise_align.launches = 0
