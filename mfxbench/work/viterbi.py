"""The Viterbi kernels' work (V1 ``viterbi_scores_multi``, V2 ``viterbi_scan``).

Frozen copies of ``chip_smoke.py``'s ``VITERBI_OPS`` and ``_viterbi_bound``
and of the port's ``ops/phmm.closure_window``: the cells a call's data
needs (each model's length, at most the padded width, times the steps of
every row, at most its width) at 15 + log2(W) float32 operations a cell for
the scores pass and 30 + 4 log2(W) for the scan pass (W the delete
closure's window), against the profile, windows and lengths read and the
outputs written once.
"""

from __future__ import annotations

from .peaks import nbytes, roofline

# operations a cell: (base, per closure round)
VITERBI_OPS = {"viterbi_scores_multi": (15, 1), "viterbi_scan": (30, 4)}


def closure_window(delete_band, scores: bool) -> int:
    """Columns the banded delete closure spans (0: the scan's exact one)."""
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


def record(name: str, prof, model_lens, seqs, lengths, band) -> dict:
    """What the bound needs, taken without a device sync: the lengths
    tensor is kept (a reference) and summed after the traced sample."""
    return {"name": name, "Lp": int(prof.msc.shape[-2]), "T": int(seqs.shape[1]),
            "rows": int(seqs.shape[0]), "model_lens": [int(x) for x in model_lens],
            "lengths": lengths, "band": band,
            "in_bytes": nbytes(*prof[:-1], seqs, lengths)}


def bound(rec: dict):
    import torch

    T = rec["T"]
    steps = int(rec["lengths"].to(torch.int64).clamp(0, T).sum())
    cells = steps * sum(min(max(L, 0), rec["Lp"]) for L in rec["model_lens"])
    base, per_round = VITERBI_OPS[rec["name"]]
    W = closure_window(rec["band"], scores=rec["name"] != "viterbi_scan")
    rounds = max(W, 1).bit_length() - 1
    out_bytes = (5 if rec["name"] == "viterbi_scan" else len(rec["model_lens"])) * 4 * rec["rows"]
    return roofline(cells * (base + per_round * rounds), rec["in_bytes"] + out_bytes)
