"""The profile-HMM local Viterbi score of each window, in plain PyTorch.

    M[t,j] = msc[j, x_t] + max(entry, M[t-1,j-1] + tMM[j], I[t-1,j-1] + tIM[j],
                               D[t-1,j-1] + tDM[j])
    I[t,j] = isc[j, x_t] + max(M[t-1,j] + tMI[j], I[t-1,j] + tII[j])
    D[t,j] = cdd[j-1] + max over i in [j-W, j-1] of (M[t,i] + tMD[i] - cdd[i])

with W the delete closure's window (16 at MitoFlex's band of 16); a base
that is N, or a position past the window's length, emits nothing (M and I
start again). The score is the largest M over every position and column;
several models run side by side on a leading axis. Every operation runs in ``dtype``: float64 for the reference, bfloat16 for
the control of the comparison.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import hmm


def _shr(x: torch.Tensor, fill: float, k: int = 1) -> torch.Tensor:
    out = torch.full_like(x, fill)
    out[..., k:] = x[..., :-k]
    return out


def _stacked(models: List[hmm.Model], dtype, device) -> Dict[str, torch.Tensor]:
    """Each array of the models, padded to the longest model's length with
    columns that emit nothing (no entry, no match or insert emission; the
    cumulative delete held at its last value) and stacked: [models, 1, L]
    (emissions [models, 4, L])."""
    L = max(m.length for m in models)
    neg = float("-inf")
    rows: Dict[str, list] = {}
    for m in models:
        a = hmm.arrays(m)
        pad = L - m.length
        for k, v in a.items():
            if k == "entry":
                v = np.full(m.length, float(v))
            fill = {"msc": neg, "isc": neg, "entry": neg}.get(k, 0.0)
            if k in ("cdd", "cdd_prev"):
                fill = float(v[-1])
            if v.ndim == 2:
                v = np.concatenate([v.T, np.full((4, pad), fill)], axis=1)
            else:
                v = np.concatenate([v, np.full(pad, fill)])[None, :]
            rows.setdefault(k, []).append(v)
    return {k: torch.as_tensor(np.stack(v), dtype=dtype, device=device)
            for k, v in rows.items()}


def scores_multi(models: List[hmm.Model], codes: np.ndarray, lengths: np.ndarray,
                 window: int = 16, dtype=torch.float64, device="cpu") -> np.ndarray:
    """Best local score [models, R] of each model on each row of ``codes``
    [R, T] (0-3 bases, anything else N) within its length, as float64; the
    models run side by side, each padded with columns that score nothing."""
    R, T = codes.shape
    a = _stacked(models, dtype, device)
    Mn, _, L = a["tmm"].shape
    neg = float("-inf")
    x = torch.as_tensor(codes.astype(np.int64), device=device)
    lens = torch.as_tensor(lengths.astype(np.int64), device=device)
    valid_all = (x >= 0) & (x < 4) & (torch.arange(T, device=device)[None, :] < lens[:, None])
    xc = x.clamp(0, 3)
    M = torch.full((Mn, R, L), neg, dtype=dtype, device=device)
    I, D = M.clone(), M.clone()
    best = torch.full((Mn, R), neg, dtype=dtype, device=device)
    negs = torch.full((Mn, R, L), neg, dtype=dtype, device=device)
    for t in range(int(lens.max().item()) if R else 0):
        valid = valid_all[None, :, t:t + 1]
        em = torch.where(valid, a["msc"][:, xc[:, t]], negs)
        ei = torch.where(valid, a["isc"][:, xc[:, t]], negs)
        arr = torch.maximum(torch.maximum(a["entry"].expand(Mn, R, L), _shr(M, neg) + a["tmm"]),
                            torch.maximum(_shr(I, neg) + a["tim"], _shr(D, neg) + a["tdm"]))
        I = ei + torch.maximum(M + a["tmi"], I + a["tii"])
        M = em + arr
        cm = M + a["tmd"] - a["cdd"]
        shift = 1
        while shift < window:
            cm = torch.maximum(cm, _shr(cm, neg, shift))
            shift *= 2
        D = _shr(cm, neg) + a["cdd_prev"]
        best = torch.maximum(best, M.max(dim=2).values)
    return best.to(torch.float64).cpu().numpy()


def scores(model: hmm.Model, codes: np.ndarray, lengths: np.ndarray, window: int = 16,
           dtype=torch.float64, device="cpu") -> np.ndarray:
    """Best local score [R] of one model on each row of ``codes``."""
    return scores_multi([model], codes, lengths, window, dtype, device)[0]
