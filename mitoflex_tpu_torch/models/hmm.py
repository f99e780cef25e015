"""HMMER3 profile-HMM model parser.

Loads the reference's per-clade CDS profile files
(profile/CDS_HMM/{clade}.hmm — HMMER3/f text format, ``ALPH DNA``, 13
protein-coding-gene models concatenated per file, each terminated by
``//``; see reference profile/CDS_HMM/Arthropoda.hmm header and SURVEY.md
§L5) into dense numpy arrays ready for the device Viterbi kernel
(ops/phmm.py).

Format notes (HMMER3/f):
- emission/transition values are negative natural logs of probabilities;
  ``*`` denotes probability zero (+inf);
- per match state k: line 1 = 4 match emissions + MAP/CONS/RF/MM/CS
  annotation columns, line 2 = 4 insert emissions, line 3 = 7 transitions
  (m->m m->i m->d i->m i->i d->m d->d);
- the block before state 1 holds the COMPO average composition and the
  node-0 insert/transition lines;
- STATS LOCAL MSV/VITERBI/FORWARD lines carry (mu/tau, lambda) for
  E-value calibration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO

import numpy as np

INF = 1e30  # -ln(0)

DNA_ORDER = "ACGT"


@dataclass
class ProfileHMM:
    name: str
    length: int                      # number of match states (LENG)
    alphabet: str                    # 'DNA' | 'RNA' | 'amino'
    match_emit: np.ndarray           # [L+1, K] -ln p (row 0 unused)
    insert_emit: np.ndarray          # [L+1, K]
    trans: np.ndarray                # [L+1, 7] -ln p; row 0 = node-0 line
    compo: Optional[np.ndarray] = None
    max_length: Optional[int] = None  # MAXL
    stats: Dict[str, tuple] = field(default_factory=dict)  # kind -> (mu, lambda)
    consensus: str = ""
    map_pos: Optional[np.ndarray] = None

    # transition column indices
    MM, MI, MD, IM, II, DM, DD = range(7)

    @property
    def k_alpha(self) -> int:
        return self.match_emit.shape[1]

    def match_scores_bits(self, background: Optional[np.ndarray] = None) -> np.ndarray:
        """[L+1, K] log2-odds match emission scores vs flat background."""
        if background is None:
            background = np.full(self.k_alpha, 1.0 / self.k_alpha)
        return (-self.match_emit - np.log(background)[None, :]) / math.log(2)

    def insert_scores_bits(self, background: Optional[np.ndarray] = None) -> np.ndarray:
        if background is None:
            background = np.full(self.k_alpha, 1.0 / self.k_alpha)
        return (-self.insert_emit - np.log(background)[None, :]) / math.log(2)

    def trans_bits(self) -> np.ndarray:
        """[L+1, 7] log2 transition scores."""
        return -self.trans / math.log(2)


def _vals(tokens: List[str]) -> List[float]:
    out = []
    for t in tokens:
        if t == "*":
            out.append(INF)
        else:
            out.append(float(t))
    return out


def parse_hmm_text(handle: TextIO) -> List[ProfileHMM]:
    """Parse a (possibly multi-model) HMMER3 text file."""
    models: List[ProfileHMM] = []
    line = handle.readline()
    while line:
        if not line.startswith("HMMER3"):
            line = handle.readline()
            continue
        # ---- header ----
        meta: Dict[str, str] = {}
        stats: Dict[str, tuple] = {}
        while True:
            line = handle.readline()
            if not line or line.startswith("HMM "):
                break
            parts = line.split(None, 1)
            if not parts:
                continue
            key = parts[0]
            rest = parts[1].strip() if len(parts) > 1 else ""
            if key == "STATS":
                toks = rest.split()
                # e.g. LOCAL VITERBI -13.6144 0.69798
                stats[toks[1]] = (float(toks[2]), float(toks[3]))
            else:
                meta[key] = rest
        if not line:
            break
        alpha_syms = line.split()[1:]  # symbol columns from the 'HMM  A C G T' line
        K = len(alpha_syms)
        handle.readline()  # transition header line
        L = int(meta["LENG"])
        match_emit = np.full((L + 1, K), INF)
        insert_emit = np.full((L + 1, K), INF)
        trans = np.full((L + 1, 7), INF)
        compo = None
        consensus = []
        map_pos = np.zeros(L + 1, dtype=np.int64)

        # node-0 block: optional COMPO line, insert-0 emissions, transitions-0
        pos = handle.tell()
        first = handle.readline().split()
        if first and first[0] == "COMPO":
            compo = np.array(_vals(first[1 : 1 + K]))
        else:
            handle.seek(pos)
        insert_emit[0] = _vals(handle.readline().split()[:K])
        trans[0] = _vals(handle.readline().split()[:7])

        for k in range(1, L + 1):
            mline = handle.readline().split()
            assert int(mline[0]) == k, (meta.get("NAME"), mline[:2])
            match_emit[k] = _vals(mline[1 : 1 + K])
            ann = mline[1 + K :]
            if len(ann) >= 1 and ann[0] != "-":
                try:
                    map_pos[k] = int(ann[0])
                except ValueError:
                    pass
            consensus.append(ann[1] if len(ann) >= 2 else "-")
            insert_emit[k] = _vals(handle.readline().split()[:K])
            trans[k] = _vals(handle.readline().split()[:7])
        closing = handle.readline()
        assert closing.strip() == "//", closing

        models.append(
            ProfileHMM(
                name=meta.get("NAME", "?"),
                length=L,
                alphabet=meta.get("ALPH", "?"),
                match_emit=match_emit,
                insert_emit=insert_emit,
                trans=trans,
                compo=compo,
                max_length=int(meta["MAXL"]) if "MAXL" in meta else None,
                stats=stats,
                consensus="".join(consensus),
                map_pos=map_pos,
            )
        )
        line = handle.readline()
    return models


def load_hmm_file(path: str) -> List[ProfileHMM]:
    with open(path) as f:
        return parse_hmm_text(f)


def profile_from_consensus(
    name: str,
    consensus: str,
    match_p: float = 0.91,
    mm: float = 0.94,
    mi: float = 0.03,
    md: float = 0.03,
    stats: Optional[Dict[str, tuple]] = None,
) -> ProfileHMM:
    """Build a simple DNA profile from a consensus string.

    Used by tests to fabricate tiny models and by the rRNA search to
    approximate a covariance model's primary-sequence signal from its
    consensus (models/cmodel.py)."""
    L = len(consensus)
    K = 4
    other = (1.0 - match_p) / 3
    match_emit = np.full((L + 1, K), -math.log(other))
    for i, ch in enumerate(consensus.upper()):
        j = DNA_ORDER.find(ch if ch != "U" else "T")
        if j >= 0:
            match_emit[i + 1, :] = -math.log(other)
            match_emit[i + 1, j] = -math.log(match_p)
        else:
            match_emit[i + 1, :] = -math.log(0.25)
    insert_emit = np.full((L + 1, K), -math.log(0.25))
    trans = np.zeros((L + 1, 7))
    trans[:, ProfileHMM.MM] = -math.log(mm)
    trans[:, ProfileHMM.MI] = -math.log(mi)
    trans[:, ProfileHMM.MD] = -math.log(md)
    trans[:, ProfileHMM.IM] = -math.log(0.8)
    trans[:, ProfileHMM.II] = -math.log(0.2)
    trans[:, ProfileHMM.DM] = -math.log(0.8)
    trans[:, ProfileHMM.DD] = -math.log(0.2)
    return ProfileHMM(
        name=name, length=L, alphabet="DNA",
        match_emit=match_emit, insert_emit=insert_emit, trans=trans,
        max_length=int(L * 1.5) + 10,
        stats=stats or {"VITERBI": (-10.0, 0.7)},
        consensus=consensus,
        map_pos=np.arange(L + 1),
    )


def write_hmm_file(models: List[ProfileHMM], path: str) -> str:
    """Emit HMMER3/f text (used by tests to fabricate tiny profiles)."""

    def fmt(v: float) -> str:
        return "      *" if v >= INF / 2 else f"{v:.5f}"

    with open(path, "w") as f:
        for m in models:
            K = m.k_alpha
            syms = list(DNA_ORDER[:K]) if m.alphabet in ("DNA", "RNA") else None
            f.write("HMMER3/f [3.1b2 | February 2015]\n")
            f.write(f"NAME  {m.name}\n")
            f.write(f"LENG  {m.length}\n")
            if m.max_length:
                f.write(f"MAXL  {m.max_length}\n")
            f.write(f"ALPH  {m.alphabet}\n")
            for kind, (mu, lam) in m.stats.items():
                f.write(f"STATS LOCAL {kind} {mu:9.4f} {lam:8.5f}\n")
            f.write("HMM          " + "        ".join(syms or [str(i) for i in range(K)]) + "\n")
            f.write("            m->m     m->i     m->d     i->m     i->i     d->m     d->d\n")
            if m.compo is not None:
                f.write("  COMPO   " + "  ".join(fmt(v) for v in m.compo) + "\n")
            f.write("          " + "  ".join(fmt(v) for v in m.insert_emit[0]) + "\n")
            f.write("          " + "  ".join(fmt(v) for v in m.trans[0]) + "\n")
            for k in range(1, m.length + 1):
                cons = m.consensus[k - 1] if k - 1 < len(m.consensus) else "x"
                mp = int(m.map_pos[k]) if m.map_pos is not None else k
                f.write(
                    f"{k:7d} " + "  ".join(fmt(v) for v in m.match_emit[k])
                    + f" {mp:6d} {cons} - -\n"
                )
                f.write("          " + "  ".join(fmt(v) for v in m.insert_emit[k]) + "\n")
                f.write("          " + "  ".join(fmt(v) for v in m.trans[k]) + "\n")
            f.write("//\n")
    return path
