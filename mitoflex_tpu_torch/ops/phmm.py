"""Profile-HMM local Viterbi scan on tensors.

Port of mitoflex_tpu/ops/phmm.py: one call scores a batch of sequence
windows against one profile (or a stack of profiles) and returns each
window's best local alignment score and its coordinates. The recurrences,
the candidate order and every tie rule are the reference's:

    M[t,j] = msc[j, x_t] + max(entry, M[t-1,j-1] + tMM, I[t-1,j-1] + tIM,
                               D[t-1,j-1] + tDM)       (first candidate wins ties)
    I[t,j] = isc[j, x_t] + max(M[t-1,j] + tMI, I[t-1,j] + tII)   (M wins ties)
    D[t,j] = c[j-1] + max_{i<j}(M[t,i] + tMD[i] - c[i]),  c = cumsum(tDD)

On a card both passes are one launch of the hand-written kernel of
``csrc/viterbi.cu`` for a whole batch (``viterbi_scores_multi`` for every
stacked model and window, ``viterbi_scan`` with the envelopes), bit-equal
to the plain versions ``viterbi_scores_multi_plain`` and
``viterbi_scan_plain``, which CPU tensors take. In those the reference's
``lax.scan`` over positions is a Python loop of tensor
steps, and its ``vmap`` over models a leading batch dimension. Emissions
are an index gather (the reference's one-hot matmul picks the same value:
one non-zero term, and ``0 * -1e30`` is ``-0.0``). The delete closure runs
as explicit ``torch.where`` doubling rounds: banded (``delete_band``, the
current column wins ties, as the reference's pairwise combine takes its
left operand) or exact (``delete_band=0``: an inclusive scan whose ties
take the leftmost column, the order of the reference's associative scan).

Scores are float32 bits; the host helpers ``length_correction_bits``,
``null2_bias_bits`` and ``evalue`` are the reference's numpy functions.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import KernelLimitError
from ..device import resolve_device
from ..models.hmm import ProfileHMM

from .sw import prefix_argmax

NEG = -1e30


class HmmHits(NamedTuple):
    score: torch.Tensor     # [B] float32 best local score (bits)
    seq_from: torch.Tensor  # [B] int32 0-based inclusive
    seq_to: torch.Tensor    # [B] int32 0-based inclusive
    hmm_from: torch.Tensor  # [B] int32 1-based model node
    hmm_to: torch.Tensor    # [B] int32


class DeviceProfile(NamedTuple):
    """Model arrays staged on a device (padded model length Lp); fields as
    the reference's, with a leading model axis once stacked."""

    msc: torch.Tensor     # [Lp, 4] match log2-odds
    isc: torch.Tensor     # [Lp, 4] insert log2-odds
    tmm: torch.Tensor     # [Lp] transitions into node j at row j-1
    tim: torch.Tensor
    tdm: torch.Tensor
    tmi: torch.Tensor     # [Lp] self transitions at node j at row j-1
    tii: torch.Tensor
    tmd: torch.Tensor
    cdd: torch.Tensor     # [Lp] cumulative tDD bits
    entry: torch.Tensor   # scalar B->M entry score (bits)
    length: int           # real model length L


def stage_profile(hmm: ProfileHMM, pad_to: int = 0, device=None) -> DeviceProfile:
    """A parsed model as padded float32 tensors on ``device``; the same
    arrays as the reference's ``stage_profile`` (padded length: the next
    power of two >= 128 unless ``pad_to`` is given)."""
    L = hmm.length
    if pad_to:
        Lp = -(-L // pad_to) * pad_to
    else:
        Lp = 128
        while Lp < L:
            Lp <<= 1
    msc_full = hmm.match_scores_bits()
    isc_full = hmm.insert_scores_bits()
    tb = hmm.trans_bits()

    def pad(v, fill):
        out = np.full((Lp,) + v.shape[1:], fill, np.float32)
        out[: v.shape[0]] = v
        return out

    tdd = np.clip(tb[1 : L + 1, ProfileHMM.DD], -1e4, 0)
    arrays = [
        pad(msc_full[1:], NEG), pad(isc_full[1:], NEG),
        pad(tb[0:L, ProfileHMM.MM], NEG), pad(tb[0:L, ProfileHMM.IM], NEG),
        pad(tb[0:L, ProfileHMM.DM], NEG),
        pad(tb[1 : L + 1, ProfileHMM.MI], NEG), pad(tb[1 : L + 1, ProfileHMM.II], NEG),
        pad(tb[1 : L + 1, ProfileHMM.MD], NEG), pad(np.cumsum(tdd), NEG),
        np.float32(math.log2(2.0 / (L * (L + 1)))),
    ]
    dev = resolve_device(device)
    return DeviceProfile(*(torch.tensor(a, device=dev) for a in arrays), L)


def stack_profiles(profs: List[DeviceProfile]) -> DeviceProfile:
    """Stack same-shape staged profiles along a leading model axis."""
    if len({tuple(p.msc.shape) for p in profs}) != 1:
        raise ValueError("profiles must share a shape bucket")
    return DeviceProfile(
        *[torch.stack([getattr(p, f) for p in profs]) for f in DeviceProfile._fields[:-1]],
        profs[0].length,
    )


def _shr(x: torch.Tensor, fill, k: int = 1) -> torch.Tensor:
    """x shifted k columns right along the last axis, ``fill`` entering."""
    return F.pad(x[..., :-k], (k, 0), value=fill)


def _step_inputs(seqs: torch.Tensor, lengths: torch.Tensor):
    """Per position: the clipped code column [T, B] and its validity
    (a base, inside the row's length)."""
    x = seqs.to(torch.int64).T
    T = x.shape[0]
    pos = torch.arange(T, device=seqs.device)[:, None]
    valid = (x < 4) & (pos < lengths.to(torch.int64)[None, :])
    return x.clamp(0, 3).contiguous(), valid


def viterbi_scan_plain(
    prof: DeviceProfile,
    seqs: torch.Tensor,      # [B, T] int8 (4 = N/pad)
    lengths: torch.Tensor,   # [B]
    model_len: int,
    delete_band: int = 16,
) -> HmmHits:
    """The plain version of :func:`viterbi_scan`: one tensor step a
    position."""
    B, T = seqs.shape
    Lp = prof.msc.shape[0]
    dev = seqs.device
    i32 = torch.int32
    jcol = torch.arange(Lp, device=dev)
    in_model = (jcol < model_len).expand(B, Lp)
    js_entry = (jcol + 1).to(i32).expand(B, Lp)
    msc_t, isc_t = prof.msc.T.contiguous(), prof.isc.T.contiguous()
    tmm, tim, tdm = prof.tmm[None], prof.tim[None], prof.tdm[None]
    tmi, tii, tmd, cdd = prof.tmi[None], prof.tii[None], prof.tmd[None], prof.cdd[None]
    cdd_prev = _shr(cdd, 0.0)
    entry = prof.entry.expand(B, Lp)
    xs, valid = _step_inputs(seqs, lengths)

    def full(v, dtype=torch.float32):
        return torch.full((B, Lp), v, dtype=dtype, device=dev)

    M, I, D, bV = full(NEG), full(NEG), full(NEG), full(NEG)
    M_ts, M_js, I_ts, I_js, D_ts, D_js = (full(0, i32) for _ in range(6))
    bV_ts, bV_js, bV_t = full(0, i32), full(0, i32), full(0, i32)
    for t in range(T):
        xv = valid[t][:, None]
        em = torch.where(xv, msc_t[xs[t]], NEG)
        ei = torch.where(xv, isc_t[xs[t]], NEG)

        # M: entry, then M, I, D arrivals; a later candidate wins only if
        # strictly greater
        best, ts, js = entry, full(t, i32), js_entry
        for val, p_ts, p_js in ((_shr(M, NEG) + tmm, M_ts, M_js),
                                (_shr(I, NEG) + tim, I_ts, I_js),
                                (_shr(D, NEG) + tdm, D_ts, D_js)):
            take = val > best
            ts = torch.where(take, _shr(p_ts, 0), ts)
            js = torch.where(take, _shr(p_js, 0), js)
            best = torch.where(take, val, best)
        M_new = torch.where(in_model, em + best, NEG)

        iv_m, iv_i = M + tmi, I + tii
        take_m = iv_m >= iv_i
        I_ts = torch.where(take_m, M_ts, I_ts)
        I_js = torch.where(take_m, M_js, I_js)
        I = torch.where(in_model, ei + torch.where(take_m, iv_m, iv_i), NEG)
        M, M_ts, M_js = M_new, ts, js

        a = torch.where(in_model, M + tmd - cdd, NEG)
        cm, cm_ts, cm_js = a, M_ts, M_js
        if delete_band and delete_band > 0:
            shift = 1
            while shift < delete_band:
                s_cm = _shr(cm, NEG, shift)
                keep = cm >= s_cm
                cm_ts = torch.where(keep, cm_ts, _shr(cm_ts, 0, shift))
                cm_js = torch.where(keep, cm_js, _shr(cm_js, 0, shift))
                cm = torch.where(keep, cm, s_cm)
                shift *= 2
        else:
            cm, col = prefix_argmax(cm)
            cm_ts, cm_js = torch.gather(cm_ts, 1, col), torch.gather(cm_js, 1, col)
        D = torch.where(in_model, _shr(cm, NEG) + cdd_prev, NEG)
        D_ts, D_js = _shr(cm_ts, 0), _shr(cm_js, 0)

        better = M > bV
        bV = torch.where(better, M, bV)
        bV_ts = torch.where(better, M_ts, bV_ts)
        bV_js = torch.where(better, M_js, bV_js)
        bV_t = torch.where(better, t, bV_t)

    endj = torch.argmax(bV, dim=1)[:, None]  # the first maximum

    def pick(x):
        return torch.gather(x, 1, endj)[:, 0]

    return HmmHits(pick(bV), pick(bV_ts), pick(bV_t), pick(bV_js),
                   (endj[:, 0] + 1).to(i32))


def viterbi_scores_multi_plain(
    profs: DeviceProfile,      # stacked: arrays with a leading model axis [M, ...]
    model_lens,                # [M] model lengths
    seqs: torch.Tensor,        # [B, T] shared windows
    lengths: torch.Tensor,     # [B]
    delete_band: int = 16,
) -> torch.Tensor:
    """The plain version of :func:`viterbi_scores_multi`: one tensor step a
    position; the reference's ``vmap`` over models is the leading axis."""
    B, T = seqs.shape
    Mn, Lp = profs.msc.shape[:2]
    dev = seqs.device
    lens_m = torch.as_tensor(model_lens, device=dev).reshape(Mn, 1, 1)
    in_model = torch.arange(Lp, device=dev)[None, None, :] < lens_m
    msc_t = profs.msc.permute(0, 2, 1).contiguous()  # [M, 4, Lp]
    isc_t = profs.isc.permute(0, 2, 1).contiguous()

    def row(x):
        return x[:, None, :]

    tmm, tim, tdm, tmi, tii = (row(getattr(profs, f)) for f in ("tmm", "tim", "tdm", "tmi", "tii"))
    tmd, cdd = row(profs.tmd), row(profs.cdd)
    cdd_prev = _shr(cdd, 0.0)
    entry = profs.entry.reshape(Mn, 1, 1)
    xs, valid = _step_inputs(seqs, lengths)
    M = torch.full((Mn, B, Lp), NEG, dtype=torch.float32, device=dev)
    I, D = M.clone(), M.clone()
    best = torch.full((Mn, B), NEG, dtype=torch.float32, device=dev)
    for t in range(T):
        xv = valid[t][None, :, None]
        em = torch.where(xv, msc_t[:, xs[t]], NEG)
        ei = torch.where(xv, isc_t[:, xs[t]], NEG)
        arr = torch.maximum(torch.maximum(entry, _shr(M, NEG) + tmm),
                            torch.maximum(_shr(I, NEG) + tim, _shr(D, NEG) + tdm))
        M_new = torch.where(in_model, em + arr, NEG)
        I = torch.where(in_model, ei + torch.maximum(M + tmi, I + tii), NEG)
        M = M_new
        cm = torch.where(in_model, M + tmd - cdd, NEG)
        shift = 1
        while shift < max(delete_band, 2):
            cm = torch.maximum(cm, _shr(cm, NEG, shift))
            shift *= 2
        D = torch.where(in_model, _shr(cm, NEG) + cdd_prev, NEG)
        best = torch.maximum(best, M.max(dim=2).values)
    return best


# ------------------------------------------------------------ the kernel
def closure_window(delete_band, scores: bool) -> int:
    """Columns the banded delete closure spans, as the plain versions' doubling
    rounds make it: the last shift of ``shift = 1; while shift < band: shift
    *= 2`` (the scores pass takes ``max(band, 2)``); 0 for the scan pass's
    exact closure."""
    if scores:
        band = max(delete_band, 2)
    elif delete_band and delete_band > 0:
        band = delete_band
    else:
        return 0
    shift = 1
    while shift < band:
        shift *= 2
    return shift


# The kernel's layout (csrc/viterbi.cu): a stage is a warp of 32 lanes, K
# columns a lane; a row's stages are the P warps of a block times the C
# blocks of a cluster; a block holds R rows.
LANES = 32
KERNEL_COLS = (1, 2, 4, 8)       # the instantiations of K
KERNEL_MAX_LP = 8192             # the widest padded model the kernel takes
KERNEL_MAX_CLUSTER = 8           # the portable cluster size
KERNEL_MAX_SMEM = 232448         # 227 KB of shared memory a block
KERNEL_DEPTH = 4                 # slots of a hand-off ring (kDepth)
KERNEL_MAX_T = 65535             # steps a row: a payload packs a step in 16 bits
# a call of at most SMs / SPREAD_ROWS rows spreads each row over a cluster
# of SPREAD_COLS-column lanes, where a row's step time is the call's time;
# more rows run at ROW_COLS columns a lane, the fewest stages (at 8 columns
# a lane the scan pass spills registers and both passes ran slower on an
# H100, PERF.md)
SPREAD_ROWS = 4
SPREAD_COLS = 1
ROW_COLS = 4


class ViterbiConfig(NamedTuple):
    """A launch layout of the Viterbi kernel."""

    cols: int     # K: columns a lane
    warps: int    # P: stages of a row in a block
    rows: int     # R: rows a block
    cluster: int  # C: blocks a row spans

    @property
    def stage_width(self) -> int:
        return LANES * self.cols

    @property
    def threads(self) -> int:
        return LANES * self.warps * self.rows


def kernel_max_threads(cols: int) -> int:
    """Threads a block may have at ``cols`` columns a lane (the launch bound
    of each instantiation)."""
    return 512 if cols == 1 else 256


def kernel_smem_bytes(cfg: ViterbiConfig, window: int, scan: bool) -> int:
    """Shared memory a block takes: per warp a ring of KERNEL_DEPTH slots of
    64-bit words (scan: M, I, D, their three packed payloads, the exact
    closure's carry and its payload, W suffix values and W payloads; scores:
    M, I, D and W suffix values) and 32 bytes of ack and final pick
    (``smem_bytes`` of the source)."""
    slot = 8 + 2 * window if scan else 3 + window
    return cfg.warps * cfg.rows * (KERNEL_DEPTH * slot * 8 + 32)


def check_config(cfg: ViterbiConfig, Lp: int, window: int, scan: bool) -> None:
    """Raise ValueError unless the kernel can run ``cfg`` at this width and
    window (the checks of the source's ``launch``)."""
    problems = []
    if cfg.cols not in KERNEL_COLS:
        problems.append(f"{cfg.cols} columns a lane")
    elif cfg.threads > kernel_max_threads(cfg.cols):
        problems.append(f"{cfg.threads} threads a block")
    if min(cfg.warps, cfg.rows, cfg.cluster) < 1 or cfg.cluster > KERNEL_MAX_CLUSTER:
        problems.append(f"warps {cfg.warps}, rows {cfg.rows}, cluster {cfg.cluster}")
    if cfg.stage_width * cfg.warps * cfg.cluster < Lp:
        problems.append(f"{cfg.stage_width * cfg.warps * cfg.cluster} columns for Lp {Lp}")
    if window > cfg.stage_width or window < (0 if scan else 1):
        problems.append(f"window {window} for a stage of {cfg.stage_width} columns")
    if kernel_smem_bytes(cfg, window, scan) > KERNEL_MAX_SMEM:
        problems.append(f"{kernel_smem_bytes(cfg, window, scan)} bytes of shared memory")
    if problems:
        raise ValueError(f"Viterbi kernel layout {tuple(cfg)}: " + ", ".join(problems))


def viterbi_config(Lp: int, rows: int, window: int, scan: bool,
                   sm_count: int = 132) -> ViterbiConfig:
    """The kernel's layout for ``rows`` rows of padded width ``Lp`` at closure
    window ``window`` (``closure_window``; 0: exact) on a card of
    ``sm_count`` SMs. A stage is at least the window wide (so a band reaches
    only into the stage on its left). Few rows (at most ``sm_count /
    SPREAD_ROWS``) spread each row over a cluster of up to 8 blocks at
    SPREAD_COLS columns a lane; more rows take ROW_COLS columns a lane, the
    fewest stages, and several rows a block where a row is one warp.
    KernelLimitError for a width over KERNEL_MAX_LP or a window wider than a
    stage can be."""
    if rows < 1 or Lp < 1:
        raise ValueError(f"viterbi_config: {rows} rows of width {Lp}")
    if window < (0 if scan else 1) or window & (window - 1):
        raise ValueError(f"viterbi_config: closure window {window}")
    if Lp > KERNEL_MAX_LP:
        raise KernelLimitError(f"Viterbi kernel: padded model length {Lp} over the "
                               f"kernel's limit of {KERNEL_MAX_LP}; the CPU path takes any")
    if window > LANES * KERNEL_COLS[-1]:
        raise KernelLimitError(f"Viterbi kernel: closure window {window} over the kernel's "
                               f"limit of {LANES * KERNEL_COLS[-1]} (delete band at most "
                               f"{LANES * KERNEL_COLS[-1]}); the CPU path takes any")
    kmin = max(1, window // LANES)
    spread = rows * SPREAD_ROWS <= sm_count
    one_stage = 1 << max(0, (-(-Lp // LANES) - 1).bit_length())  # K of a one-stage row
    K = max(kmin, SPREAD_COLS if spread else min(ROW_COLS, one_stage))
    while True:
        stages = -(-Lp // (LANES * K))
        C = min(KERNEL_MAX_CLUSTER, stages) if spread else 1
        P = -(-stages // C)
        while LANES * P > kernel_max_threads(K) and C < KERNEL_MAX_CLUSTER:
            C *= 2
            P = -(-stages // C)
        if LANES * P <= kernel_max_threads(K):
            break
        K *= 2
    # rows a block: half the instantiation's threads, so that two blocks
    # share an SM (the largest pick, K 8 at window 256, takes 133 KB of
    # shared memory; check_config holds every pick to the card's limits)
    R = 1 if spread else max(1, kernel_max_threads(K) // (LANES * P * 2))
    cfg = ViterbiConfig(K, P, R, C)
    check_config(cfg, Lp, window, scan)
    return cfg


def viterbi_configs(Lp: int, window: int, scan: bool, sm_count: int = 132) -> list:
    """Every layout ``viterbi_config`` can pick at this width and window, for
    any number of rows."""
    counts = set(range(1, 257)) | {1 << i for i in range(8, 21)} \
        | {max(1, sm_count // SPREAD_ROWS + d) for d in (-1, 0, 1)}
    return sorted({viterbi_config(Lp, r, window, scan, sm_count) for r in counts})


_SM_COUNTS: dict = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SM_COUNTS:
        _SM_COUNTS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNTS[dev.index]


def _layout(dev, Lp: int, rows: int, window: int, scan: bool, config) -> ViterbiConfig:
    """The layout of one launch: ``config`` where the caller forces one
    (checked), else ``viterbi_config`` for this card."""
    if config is None:
        return viterbi_config(Lp, rows, window, scan, _sm_count(dev))
    cfg = ViterbiConfig(*config)
    check_config(cfg, Lp, window, scan)
    return cfg


def _check_inputs(what: str, prof: DeviceProfile, lead: tuple, seqs: torch.Tensor,
                  lengths: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these tensors: float32
    profile arrays of shapes ``lead + [Lp, 4]`` / ``lead + [Lp]`` / ``lead``,
    int8 windows [B, T], int32 lengths [B], all contiguous on one card."""
    dev = seqs.device
    Lp = prof.msc.shape[-2] if prof.msc.dim() >= 2 else -1
    wants = {"msc": lead + (Lp, 4), "isc": lead + (Lp, 4), "entry": lead}
    for f in DeviceProfile._fields[:-1]:
        t = getattr(prof, f)
        want = wants.get(f, lead + (Lp,))
        if t.dtype != torch.float32 or tuple(t.shape) != want or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: profile {f} must be a contiguous float32 tensor "
                             f"of shape {list(want)} on {dev}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
    if seqs.dim() != 2 or seqs.dtype != torch.int8 or not seqs.is_contiguous():
        raise ValueError(f"{what}: seqs must be a contiguous int8 tensor [B, T], got "
                         f"{seqs.dtype} {list(seqs.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (seqs.shape[0],) \
            or lengths.device != dev or not lengths.is_contiguous():
        raise ValueError(f"{what}: lengths must be a contiguous int32 tensor "
                         f"[{seqs.shape[0]}] on {dev}, got {lengths.dtype} "
                         f"{list(lengths.shape)} on {lengths.device}")


def _check_steps(what: str, T: int) -> None:
    if T > KERNEL_MAX_T:
        raise KernelLimitError(f"{what}: windows of {T} positions over the kernel's limit "
                               f"of {KERNEL_MAX_T}; the CPU path takes any")


def _profile_ptrs(prof: DeviceProfile) -> list:
    return [getattr(prof, f).data_ptr() for f in DeviceProfile._fields[:-1]]


def viterbi_scan(
    prof: DeviceProfile,
    seqs: torch.Tensor,      # [B, T] int8 (4 = N/pad)
    lengths: torch.Tensor,   # [B] int32
    model_len: int,
    delete_band: int = 16,
    *,
    _config=None,
) -> HmmHits:
    """Best local score per window with its envelope (sequence and model
    from/to), carried through the forward pass. ``delete_band`` bounds the
    delete-chain closure (0: exact). Tensors on a card: one launch of the
    kernel of ``csrc/viterbi.cu`` for the whole batch (bit-equal to the plain
    version; layout from ``viterbi_config``, ``_config`` forces one for the
    kernel's checks); on the CPU: :func:`viterbi_scan_plain`."""
    dev = seqs.device
    if dev.type == "cpu":
        return viterbi_scan_plain(prof, seqs, lengths, model_len, delete_band)
    if dev.type != "cuda":
        raise ValueError(f"viterbi_scan: unsupported device {dev}")
    _check_inputs("viterbi_scan", prof, (), seqs, lengths)
    B, T = seqs.shape
    Lp = prof.msc.shape[0]
    _check_steps("viterbi_scan", T)
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    if B:
        W = closure_window(delete_band, scores=False)
        cfg = _layout(dev, Lp, B, W, True, _config)
        ml = max(min(int(model_len), Lp), 0)
        err = kernels.launch(
            dev, kernels.library().mfx_viterbi_scan, *_profile_ptrs(prof), ml,
            seqs.data_ptr(), lengths.data_ptr(), B, T, Lp, W, *cfg, out.data_ptr())
        if err:
            kernels.check(err, "viterbi_scan")
        viterbi_scan.launches += 1
    return HmmHits(out[0].view(torch.float32), out[1], out[2], out[3], out[4])


def viterbi_scores_multi(
    profs: DeviceProfile,      # stacked: arrays with a leading model axis [M, ...]
    model_lens,                # [M] model lengths
    seqs: torch.Tensor,        # [B, T] int8 shared windows
    lengths: torch.Tensor,     # [B] int32
    delete_band: int = 16,
    *,
    _config=None,
) -> torch.Tensor:
    """[M, B] best scores (no envelopes): every model scans every window.
    Tensors on a card: one launch of the kernel of ``csrc/viterbi.cu`` for
    all models and windows (bit-equal to the plain version; layout from
    ``viterbi_config``, ``_config`` forces one for the kernel's checks); on
    the CPU: :func:`viterbi_scores_multi_plain`."""
    dev = seqs.device
    if dev.type == "cpu":
        return viterbi_scores_multi_plain(profs, model_lens, seqs, lengths, delete_band)
    if dev.type != "cuda":
        raise ValueError(f"viterbi_scores_multi: unsupported device {dev}")
    Mn = profs.msc.shape[0]
    _check_inputs("viterbi_scores_multi", profs, (Mn,), seqs, lengths)
    B, T = seqs.shape
    Lp = profs.msc.shape[1]
    _check_steps("viterbi_scores_multi", T)
    lens = torch.as_tensor(model_lens).reshape(-1)
    if lens.numel() != Mn:
        raise ValueError(f"viterbi_scores_multi: {lens.numel()} model lengths for "
                         f"{Mn} models")
    lens = lens.clamp(0, Lp).to(device=dev, dtype=torch.int32)
    out = torch.empty((Mn, B), dtype=torch.float32, device=dev)
    if Mn and B:
        W = closure_window(delete_band, scores=True)
        cfg = _layout(dev, Lp, Mn * B, W, False, _config)
        err = kernels.launch(
            dev, kernels.library().mfx_viterbi_scores, *_profile_ptrs(profs),
            lens.data_ptr(), Mn, seqs.data_ptr(), lengths.data_ptr(), B, T, Lp, W, *cfg,
            out.data_ptr())
        if err:
            kernels.check(err, "viterbi_scores_multi")
        viterbi_scores_multi.launches += 1
    return out


# kernel launches since the last reset (plain counters, never reset here)
viterbi_scan.launches = 0
viterbi_scores_multi.launches = 0


def viterbi_scores(prof: DeviceProfile, seqs: torch.Tensor, lengths: torch.Tensor,
                   model_len: int, delete_band: int = 16) -> torch.Tensor:
    """[B] best scores of one profile (the scores-only sweep)."""
    return viterbi_scores_multi(stack_profiles([prof]), [model_len], seqs, lengths,
                                delete_band)[0]


# ------------------------------------------------------------ host helpers
def evalue(score_bits: np.ndarray, mu: float, lam: float, n_targets: float) -> np.ndarray:
    """Gumbel tail: P(S >= x) ~= exp(-lambda * (x - mu)); E = n * P."""
    z = np.clip(-lam * (np.asarray(score_bits, dtype=np.float64) - mu), -700, 700)
    p = np.exp(z)
    return np.minimum(n_targets * p, n_targets)


def null2_bias_bits(
    seqs: np.ndarray, seq_from: np.ndarray, seq_to: np.ndarray,
    omega_bits: float = 3.0,
) -> np.ndarray:
    """Composition-bias (null2) score correction in bits, host-side: the
    envelope-composition approximation of HMMER's null2,

        n2   = sum_b count_b * log2(f_b / 0.25),  f plus-one smoothed,
        corr = log2(1 + 2^(n2 - omega_bits)).

    seqs: [B, T] int8 codes; seq_from/seq_to: [B] 0-based inclusive
    envelope bounds. Returns [B] float64 bits (>= 0)."""
    seqs = np.asarray(seqs)
    B, T = seqs.shape
    sf = np.clip(np.asarray(seq_from, np.int64), 0, T - 1)
    st = np.clip(np.asarray(seq_to, np.int64), 0, T - 1)
    col = np.arange(T)[None, :]
    in_env = (col >= sf[:, None]) & (col <= st[:, None])
    counts = np.stack(
        [((seqs == b) & in_env).sum(axis=1) for b in range(4)], axis=1
    ).astype(np.float64)
    n = counts.sum(axis=1, keepdims=True)
    f = (counts + 1.0) / (n + 4.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        n2 = np.where(counts > 0, counts * np.log2(f / 0.25), 0.0).sum(axis=1)
    n2 = np.maximum(n2, 0.0)
    return np.log1p(np.exp2(np.minimum(n2 - omega_bits, 500.0))) / np.log(2.0)


def length_correction_bits(target_len, ali_len) -> np.ndarray:
    """HMMER's NJC length-model score correction in bits (host-side,
    single-hit): unaligned residues loop in N or C at L/(L+3), N->B and
    C->T cost log(3/(L+3)), E->C log(1/2), minus the null1 length score.
    Apply as ``score + length_correction_bits``."""
    Lw = np.maximum(np.asarray(target_len, np.float64), 1.0)
    d = np.clip(np.asarray(ali_len, np.float64), 0.0, Lw)
    ln = np.log
    special = (
        (Lw - d) * ln(Lw / (Lw + 3.0))
        + 2.0 * ln(3.0 / (Lw + 3.0))
        + ln(0.5)
    )
    null1 = Lw * ln(Lw / (Lw + 1.0)) + ln(1.0 / (Lw + 1.0))
    return (special - null1) / ln(2.0)
