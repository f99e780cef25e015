"""HMMER3/f text -> the local Viterbi recurrence's score arrays, in float64.

The bit scores are those of a flat background (log2-odds of each emission
against 1/4) and log2 transitions; the recurrence's arrays are laid out as
MitoFlex's profile Viterbi reads them: column j is match state j + 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

MM, MI, MD, IM, II, DM, DD = range(7)


@dataclass
class Model:
    name: str
    length: int
    match_nll: np.ndarray   # [L+1, 4] -ln p, row 0 unused
    insert_nll: np.ndarray  # [L+1, 4]
    trans_nll: np.ndarray   # [L+1, 7]


def _row(tokens) -> List[float]:
    if "*" in tokens:
        raise ValueError("a probability of zero: the reference takes finite scores only")
    return [float(t) for t in tokens]


def parse(text: str) -> Dict[str, Model]:
    models: Dict[str, Model] = {}
    lines = iter(text.splitlines())
    for line in lines:
        if not line.startswith("HMMER3"):
            continue
        meta = {}
        for line in lines:
            if line.startswith("HMM "):
                break
            key, _, rest = line.partition(" ")
            meta[key] = rest.strip()
        next(lines)  # transition header
        L = int(meta["LENG"])
        match = np.zeros((L + 1, 4))
        insert = np.zeros((L + 1, 4))
        trans = np.zeros((L + 1, 7))
        first = next(lines).split()
        if first[0] == "COMPO":
            first = next(lines).split()
        insert[0] = _row(first[:4])
        trans[0] = _row(next(lines).split()[:7])
        for k in range(1, L + 1):
            fields = next(lines).split()
            if int(fields[0]) != k:
                raise ValueError(f"{meta.get('NAME')}: node {fields[0]} where {k} is due")
            match[k] = _row(fields[1:5])
            insert[k] = _row(next(lines).split()[:4])
            trans[k] = _row(next(lines).split()[:7])
        if next(lines).strip() != "//":
            raise ValueError(f"{meta.get('NAME')}: no // after node {L}")
        models[meta["NAME"]] = Model(meta["NAME"], L, match, insert, trans)
    return models


def arrays(m: Model) -> Dict[str, np.ndarray]:
    """The recurrence's float64 arrays of ``m`` (each [L], emissions [L, 4])."""
    L = m.length
    ln2 = math.log(2.0)
    tb = -m.trans_nll / ln2
    tdd = np.clip(tb[1:L + 1, DD], -1e4, 0.0)
    cdd = np.cumsum(tdd)
    return {
        "msc": (-m.match_nll[1:] - math.log(0.25)) / ln2,
        "isc": (-m.insert_nll[1:] - math.log(0.25)) / ln2,
        "tmm": tb[0:L, MM], "tim": tb[0:L, IM], "tdm": tb[0:L, DM],
        "tmi": tb[1:L + 1, MI], "tii": tb[1:L + 1, II], "tmd": tb[1:L + 1, MD],
        "cdd": cdd, "cdd_prev": np.concatenate([[0.0], cdd[:-1]]),
        "entry": np.float64(math.log2(2.0 / (L * (L + 1)))),
    }
