"""HMMER3/f text for DNA profile HMMs built from a consensus.

A frozen copy of ``profile_from_consensus`` and ``write_hmm_file`` of the
port's ``models/hmm.py``, kept with the benchmark so that the profiles a
cell searches with do not change when the program does. numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

INF = 1e30  # -ln(0)
DNA_ORDER = "ACGT"
MM, MI, MD, IM, II, DM, DD = range(7)


@dataclass
class ConsensusHMM:
    name: str
    length: int
    match_emit: np.ndarray   # [L+1, 4] -ln p (row 0 unused)
    insert_emit: np.ndarray  # [L+1, 4]
    trans: np.ndarray        # [L+1, 7] -ln p
    max_length: int
    consensus: str
    stats: Dict[str, tuple] = field(default_factory=lambda: {"VITERBI": (-10.0, 0.7)})


def profile_from_consensus(name: str, consensus: str, match_p: float = 0.91,
                           mm: float = 0.94, mi: float = 0.03,
                           md: float = 0.03) -> ConsensusHMM:
    L = len(consensus)
    other = (1.0 - match_p) / 3
    match_emit = np.full((L + 1, 4), -math.log(other))
    for i, ch in enumerate(consensus.upper()):
        j = DNA_ORDER.find(ch if ch != "U" else "T")
        if j >= 0:
            match_emit[i + 1, :] = -math.log(other)
            match_emit[i + 1, j] = -math.log(match_p)
        else:
            match_emit[i + 1, :] = -math.log(0.25)
    insert_emit = np.full((L + 1, 4), -math.log(0.25))
    trans = np.zeros((L + 1, 7))
    trans[:, MM] = -math.log(mm)
    trans[:, MI] = -math.log(mi)
    trans[:, MD] = -math.log(md)
    trans[:, IM] = -math.log(0.8)
    trans[:, II] = -math.log(0.2)
    trans[:, DM] = -math.log(0.8)
    trans[:, DD] = -math.log(0.2)
    return ConsensusHMM(name, L, match_emit, insert_emit, trans, int(L * 1.5) + 10,
                        consensus)


def hmm_text(models: List[ConsensusHMM]) -> str:
    """The models as one HMMER3/f text."""

    def fmt(v: float) -> str:
        return "      *" if v >= INF / 2 else f"{v:.5f}"

    out: List[str] = []
    for m in models:
        out += ["HMMER3/f [3.1b2 | February 2015]", f"NAME  {m.name}", f"LENG  {m.length}",
                f"MAXL  {m.max_length}", "ALPH  DNA"]
        out += [f"STATS LOCAL {kind} {mu:9.4f} {lam:8.5f}" for kind, (mu, lam) in m.stats.items()]
        out.append("HMM          " + "        ".join(DNA_ORDER))
        out.append("            m->m     m->i     m->d     i->m     i->i     d->m     d->d")
        out.append("          " + "  ".join(fmt(v) for v in m.insert_emit[0]))
        out.append("          " + "  ".join(fmt(v) for v in m.trans[0]))
        for k in range(1, m.length + 1):
            cons = m.consensus[k - 1] if k - 1 < len(m.consensus) else "x"
            out.append(f"{k:7d} " + "  ".join(fmt(v) for v in m.match_emit[k])
                       + f" {k:6d} {cons} - -")
            out.append("          " + "  ".join(fmt(v) for v in m.insert_emit[k]))
            out.append("          " + "  ".join(fmt(v) for v in m.trans[k]))
        out.append("//")
    return "\n".join(out) + "\n"
