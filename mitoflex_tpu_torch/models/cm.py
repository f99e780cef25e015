"""Infernal covariance-model (CM) parser.

Loads the reference's tRNA/rRNA models (profile/tRNA_CM/Metazoa_{AA}.cm,
profile/rRNA_CM/{12s,16s}.cm — INFERNAL1/a text format; see reference
profile headers) into dense arrays for the CYK op (ops/cyk.py).

File layout: header key/values, a ``CM`` line, then per-node blocks — a
node line ``[ NODETYPE idx ] mapL mapR consL consR rfL rfR`` followed by
its state lines

    sttype stid plast pnum cfirst cnum dmin2 dmin1 dmax1 dmax2 \
        t(0..cnum-1) ... [emissions: 4 for ML/MR/IL/IR, 16 for MP]

terminated by ``//``, followed by an embedded HMMER3/f filter profile
(also ``//``-terminated) which we parse too — it drives the windowing /
rRNA search through the same Viterbi engine as nhmmer (ops/phmm.py).

Scores in the file are log2-odds bits (``*`` = -inf). Transitions from a
normal state v go to states cfirst..cfirst+cnum-1; for B (bifurcation)
states cfirst/cnum are instead the LEFT and RIGHT child S states.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from . import hmm as hmm_models

NEG = -1e30

# state types
S, D, MP, ML, MR, IL, IR, B, E = range(9)
STATE_NAMES = {"S": S, "D": D, "MP": MP, "ML": ML, "MR": MR, "IL": IL, "IR": IR, "B": B, "E": E}
STATE_STR = {v: k for k, v in STATE_NAMES.items()}

# node types
NODE_NAMES = ("ROOT", "MATP", "MATL", "MATR", "BIF", "BEGL", "BEGR", "END")


@dataclass
class CmNode:
    kind: str
    cons_left: str
    cons_right: str
    state_ids: List[int] = field(default_factory=list)


@dataclass
class CovarianceModel:
    name: str
    n_states: int
    n_nodes: int
    clen: int
    window: int
    stype: np.ndarray          # [S] int8 state type codes
    node_of: np.ndarray        # [S] int32 node index
    cfirst: np.ndarray         # [S] int32
    cnum: np.ndarray           # [S] int32
    trans: np.ndarray          # [S, max_c] float32 bits (NEG pad)
    emit_pair: np.ndarray      # [S, 16] float32 (MP states; NEG elsewhere)
    emit_single: np.ndarray    # [S, 4] float32 (ML/MR/IL/IR)
    nodes: List[CmNode] = field(default_factory=list)
    filter_hmm: Optional[hmm_models.ProfileHMM] = None
    stats: Dict[str, tuple] = field(default_factory=dict)

    @property
    def max_children(self) -> int:
        return self.trans.shape[1]

    def consensus(self) -> str:
        """Primary-sequence consensus in model-coordinate order, emitted by
        a guide-tree walk (left emission, subtree, right emission; BIF
        nodes splice their BEGL then BEGR subtrees)."""
        out: List[str] = []

        def b_children(idx: int) -> Tuple[int, int]:
            for sid in self.nodes[idx].state_ids:
                if self.stype[sid] == B:
                    return int(self.node_of[self.cfirst[sid]]), int(self.node_of[self.cnum[sid]])
            raise ValueError("BIF node without B state")

        def walk(idx: int) -> None:
            kind = self.nodes[idx].kind
            if kind == "END":
                return
            if kind == "BIF":
                l, r = b_children(idx)
                walk(l)
                walk(r)
                return
            if kind in ("MATL", "MATP"):
                out.append(self.nodes[idx].cons_left)
            walk(idx + 1)
            if kind in ("MATR", "MATP"):
                out.append(self.nodes[idx].cons_right)

        walk(0)
        return "".join(out)


def _score(tok: str) -> float:
    return NEG if tok == "*" else float(tok)


def parse_cm_text(handle: TextIO) -> List[CovarianceModel]:
    models: List[CovarianceModel] = []
    line = handle.readline()
    while line:
        if not line.startswith("INFERNAL"):
            line = handle.readline()
            continue
        meta: Dict[str, str] = {}
        stats: Dict[str, tuple] = {}
        while True:
            line = handle.readline()
            if not line or line.strip() == "CM":
                break
            parts = line.split(None, 1)
            if not parts:
                continue
            key, rest = parts[0], (parts[1].strip() if len(parts) > 1 else "")
            if key.startswith("ECM") or key == "EFP7GF":
                # ECM*: lambda, mu_extrap, mu_orig, dbsize, nhits, tailp
                stats[key] = tuple(float(x) for x in rest.split())
            else:
                meta[key] = rest
        n_states = int(meta["STATES"])
        n_nodes = int(meta["NODES"])

        stype = np.zeros(n_states, np.int8)
        node_of = np.zeros(n_states, np.int32)
        cfirst = np.full(n_states, -1, np.int32)
        cnum = np.zeros(n_states, np.int32)
        trans_rows: List[List[float]] = [[] for _ in range(n_states)]
        emit_pair = np.full((n_states, 16), NEG, np.float32)
        emit_single = np.full((n_states, 4), NEG, np.float32)
        # nodes indexed by their DECLARED number (guide-tree preorder):
        # the file may lay out bifurcation subtrees in a different order
        # than the numbering (state ids follow file order, node numbers
        # follow the tree)
        nodes: List[CmNode] = [None] * n_nodes  # type: ignore

        cur_node = -1
        while True:
            line = handle.readline()
            if not line:
                raise ValueError("unterminated CM section")
            s = line.strip()
            if s == "//":
                break
            if s.startswith("["):
                toks = s.replace("[", " ").replace("]", " ").split()
                kind = toks[0]
                cur_node = int(toks[1])
                rest = toks[2:]
                cons_l = rest[2] if len(rest) > 3 else "-"
                cons_r = rest[3] if len(rest) > 3 else "-"
                nodes[cur_node] = CmNode(kind, cons_l, cons_r)
                continue
            toks = s.split()
            st = STATE_NAMES[toks[0]]
            sid = int(toks[1])
            stype[sid] = st
            node_of[sid] = cur_node
            nodes[cur_node].state_ids.append(sid)
            cfirst[sid] = int(toks[4])
            cnum[sid] = int(toks[5])
            vals = toks[10:]
            if st == B:
                n_t, n_e = 0, 0
            elif st == E:
                n_t, n_e = 0, 0
            else:
                n_t = int(toks[5])
                n_e = 16 if st == MP else (4 if st in (ML, MR, IL, IR) else 0)
            trans_rows[sid] = [_score(v) for v in vals[:n_t]]
            if n_e:
                em = [_score(v) for v in vals[n_t : n_t + n_e]]
                if st == MP:
                    emit_pair[sid] = em
                else:
                    emit_single[sid] = em

        max_c = max((len(r) for r in trans_rows), default=1) or 1
        trans = np.full((n_states, max_c), NEG, np.float32)
        for i, r in enumerate(trans_rows):
            trans[i, : len(r)] = r

        # embedded p7 filter HMM follows immediately
        filter_hmm = None
        pos = handle.tell()
        nxt = handle.readline()
        if nxt.startswith("HMMER3"):
            handle.seek(pos)
            parsed = hmm_models.parse_hmm_text(handle)
            if parsed:
                filter_hmm = parsed[0]
        else:
            handle.seek(pos)

        models.append(
            CovarianceModel(
                name=meta.get("NAME", "?"),
                n_states=n_states,
                n_nodes=n_nodes,
                clen=int(meta["CLEN"]),
                window=int(meta.get("W", meta["CLEN"])),
                stype=stype,
                node_of=node_of,
                cfirst=cfirst,
                cnum=cnum,
                trans=trans,
                emit_pair=emit_pair,
                emit_single=emit_single,
                nodes=nodes,
                filter_hmm=filter_hmm,
                stats=stats,
            )
        )
        line = handle.readline()
    return models


def load_cm_file(path: str) -> List[CovarianceModel]:
    with open(path) as f:
        return parse_cm_text(f)


@dataclass
class LocalConfig:
    """Infernal-style local-mode parameters for a CM (cmsearch default).

    Local BEGINS let the parse tree attach directly to any internal
    MATP/MATL/MATR/BIF node (probability ``pbegin`` spread uniformly over
    the internal candidates; node 1's entry keeps ``1-pbegin``). Local
    ENDS let eligible states transition to a special EL state that emits
    the remainder of their subtree's span at ``el_selfprob`` per residue
    (probability ``pend`` spread uniformly; the state's own transitions
    are renormalised by the complement). Together these score 5'/3'-
    TRUNCATED hits sensibly — the part of the model falling off the
    window edge is skipped via a begin/end instead of a ruinous chain of
    delete transitions. This mirrors Infernal's cm_ConfigLocal defaults
    (pbegin = pend = 0.05, el self-probability 0.94); the reference runs
    cmsearch in this default local mode (annotation_tookit.py:394).
    """

    begin_sc: np.ndarray   # [S] bits; NEG where not a begin candidate
    end_sc: np.ndarray     # [S] bits; NEG where not an end candidate
    trans_adj: np.ndarray  # [S] bits added to every transition out of v
    el_selfsc: float       # bits per EL-emitted residue


def local_config(
    model: "CovarianceModel",
    pbegin: float = 0.05,
    pend: float = 0.05,
    el_selfprob: float = 0.94,
) -> LocalConfig:
    """Compute local begin/end score vectors for ``model`` (see
    :class:`LocalConfig`)."""
    Sn = model.n_states
    begin_sc = np.full(Sn, NEG, np.float32)
    end_sc = np.full(Sn, NEG, np.float32)
    trans_adj = np.zeros(Sn, np.float32)

    begin_kinds = ("MATP", "MATL", "MATR", "BIF")
    cands = [
        nd for nd in range(1, model.n_nodes)
        if model.nodes[nd].kind in begin_kinds and model.nodes[nd].state_ids
    ]
    # node 1 (when it is a begin kind, as cmbuild always makes it) keeps the
    # 1-pbegin mass; the pbegin remainder spreads over the OTHER candidates.
    # If a degenerate guide tree has no begin-kind node 1, spread the full
    # mass uniformly so begin probabilities still sum to 1.
    node1_is_cand = bool(cands) and cands[0] == 1
    others = len(cands) - 1 if node1_is_cand else len(cands)
    for nd in cands:
        first = model.nodes[nd].state_ids[0]
        if node1_is_cand and nd == 1:
            begin_sc[first] = np.log2(1.0 - pbegin)
        elif node1_is_cand:
            begin_sc[first] = np.log2(pbegin / max(others, 1))
        else:
            begin_sc[first] = np.log2(1.0 / max(others, 1))

    end_kinds = ("MATP", "MATL", "MATR", "BEGL", "BEGR")
    exits = [
        nd for nd in range(1, model.n_nodes - 1)
        if model.nodes[nd].kind in end_kinds
        and model.nodes[nd + 1].kind != "END"
        and model.nodes[nd].state_ids
    ]
    if exits:
        p_exit = pend / len(exits)
        for nd in exits:
            first = model.nodes[nd].state_ids[0]
            end_sc[first] = np.log2(p_exit)
            trans_adj[first] = np.log2(1.0 - p_exit)

    return LocalConfig(
        begin_sc=begin_sc,
        end_sc=end_sc,
        trans_adj=trans_adj,
        el_selfsc=float(np.log2(el_selfprob)),
    )


def cm_evalue(model: "CovarianceModel", score_bits: float,
              search_residues: float, key: str = "ECMLC") -> float | None:
    """Infernal-style exponential-tail E-value for a CM bit score.

    The .cm ECM* lines carry (lambda, mu_extrap, mu_orig, dbsize, nhits,
    tailp) from cmcalibrate; the locally-configured CYK line (ECMLC)
    matches our banded-CYK search mode. E = eff_dbsize * exp(-lambda *
    (sc - mu_extrap)) with eff_dbsize = nhits * search_residues / dbsize
    (Infernal's per-search rescaling of the calibrated hit count).
    Returns None when the model carries no calibration."""
    st = model.stats.get(key)
    if not st or len(st) < 6:
        return None
    lam, mu_ex, _mu_orig, dbsize, nhits, _tailp = st[:6]
    import math
    eff = nhits * max(search_residues, 1.0) / max(dbsize, 1.0)
    # Infernal clamps the exponential-tail survival at 1.0 (esl_exp_surv
    # returns 1.0 for sc < mu), so E never exceeds the search-space size
    surv = min(1.0, math.exp(max(min(-lam * (score_bits - mu_ex), 700.0), -700.0)))
    return eff * surv
