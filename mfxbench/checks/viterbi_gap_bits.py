"""nhmmer's Viterbi scores against the reference recurrence in float64: the
widest gap, in bits, between a score that the card's pass 1 (V1) or pass 2
(V2) returned under findmitoscaf and the reference's score of the same
model on the same window. The calls are a reservoir drawn from the seed
(``harness.ViterbiRecorder``); of each, the best-scoring window of every
model and three more drawn from the seed. The control (``control.py``)
puts the reference computed in bfloat16, the precision below the float32
that the configuration states, in the place of exactly these calls."""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..reference import hmm as ref_hmm
from ..reference import viterbi as ref_viterbi
from ..work.viterbi import closure_window

LIMIT = 0.05
EXTRA_ROWS = 3
NONE = -1e29  # at or below: no local alignment at all (an empty or all-N window)


def models(cell) -> Dict[str, ref_hmm.Model]:
    """The configuration's PCG models, parsed by the reference from the
    profile set's HMM text."""
    with open(f"{cell.mito.profile_dir}/CDS_HMM/{cell.mito.clade}.hmm") as f:
        return ref_hmm.parse(f.read())


def names_by_length(cell) -> Dict[int, str]:
    """Model length -> model name: a call names its models by length."""
    by_len = {}
    for name, L in cell.mito.hmm_lengths.items():
        if L in by_len:
            raise ValueError(f"models {by_len[L]} and {name} share a length")
        by_len[L] = name
    return by_len


def window_of(pass_name: str, args, kwargs) -> int:
    """The delete closure's window of a call, as the reference takes it."""
    band = args[4] if len(args) > 4 else kwargs.get("delete_band", 16)
    return closure_window(band, scores=pass_name == "viterbi_scores_multi") or 10 ** 6


def items(cell) -> List[Tuple[str, np.ndarray, int, float, int]]:
    """(model, window codes, length, program's score, closure window) of
    each compared score."""
    by_len = names_by_length(cell)
    rng = random.Random(cell.seed)
    out = []
    for pass_name, calls in cell.viterbi.kept.items():
        for args, kwargs, res in calls:
            if pass_name == "viterbi_scores_multi":
                _, lens, seqs, lengths = args[:4]
                scores = res.detach().cpu().numpy()
            else:
                _, seqs, lengths, L = args[:4]
                lens, scores = [L], res.score.detach().cpu().numpy()[None, :]
            W = window_of(pass_name, args, kwargs)
            codes = seqs.detach().cpu().numpy()
            lengths = lengths.detach().cpu().numpy()
            B = codes.shape[0]
            for m, L in enumerate(lens):
                rows = {int(np.argmax(scores[m]))} | set(rng.sample(range(B), min(EXTRA_ROWS, B)))
                for r in sorted(rows):
                    if lengths[r] <= 0:
                        continue
                    out.append((by_len[int(L)], codes[r], int(lengths[r]), float(scores[m, r]), W))
    return out


def _reference(cell, its) -> np.ndarray:
    parsed = models(cell)
    groups: Dict[tuple, List[int]] = {}
    for i, (name, _, _, _, W) in enumerate(its):
        groups.setdefault((name, W), []).append(i)
    ref = np.zeros(len(its))
    for (name, W), idx in groups.items():
        T = max(its[i][2] for i in idx)
        codes = np.full((len(idx), max(T, 1)), 4, np.int64)
        for j, i in enumerate(idx):
            codes[j, : its[i][2]] = its[i][1][: its[i][2]]
        lengths = np.array([its[i][2] for i in idx])
        ref[idx] = ref_viterbi.scores(parsed[name], codes, lengths, W, torch.float64, cell.device)
    return ref


def gap(a: np.ndarray, b: np.ndarray) -> float:
    """The widest |a - b|; two scores that both say "no alignment" agree."""
    both_none = (a <= NONE) & (b <= NONE)
    return float(np.max(np.where(both_none, 0.0, np.abs(a - b)))) if len(a) else 0.0


def compare(cell) -> float:
    its = items(cell)
    if not its:
        raise ValueError("no Viterbi call under findmitoscaf was kept")
    return gap(np.array([x[3] for x in its]), _reference(cell, its))

