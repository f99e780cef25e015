"""Seeded covariance models as Infernal-format CM text.

A frozen copy of the port's ``testing/cm_fixture.py``, kept with the
benchmark so that the models a cell searches with do not change when the
program does. numpy only.

The tRNA and rRNA searches need covariance models (Infernal ``.cm`` files
with an embedded HMMER3 filter profile). This module writes such files from
a seed, so that the CM paths can be exercised and held against each other
without any external profile set:

- :func:`trna_cm`: a tRNA-like cloverleaf, consensus length 72: an acceptor
  stem around a multiloop of three hairpins (D arm, anticodon arm with a
  7-base loop, T arm), a variable region and an unpaired 3' base. Its model
  tree has two bifurcations, so ROOT, MATP, MATL, MATR, BIF, BEGL, BEGR and
  END nodes and the IL / IR self-loops all occur. The anticodon is given by
  the caller.
- :func:`rrna_cm`: a multi-domain structure of a given consensus length
  (about 950 gives about 2,900 states, the size of a 12S rRNA model).

Emissions are peaked on a seeded consensus (Watson-Crick or G-U pairs in the
stems), transitions favour the consensus path, a valid ``ECMLC`` calibration
line is written, and the filter profile is built from the same consensus
with ``hmm_text.profile_from_consensus``. Each fixture also carries its consensus as DNA and its
dot-bracket structure, so that a test can plant it in a genome.

The text is read by the port's ``models.cm.parse_cm_text``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


from . import hmm_text

RNA = "ACGU"
_PAIRS = ("AU", "UA", "CG", "GC", "GU", "UG")

# node kind -> (split-set states, insert states), in file order
_NODE_STATES = {
    "ROOT": (("S",), ("IL", "IR")),
    "MATP": (("MP", "ML", "MR", "D"), ("IL", "IR")),
    "MATL": (("ML", "D"), ("IL",)),
    "MATR": (("MR", "D"), ("IR",)),
    "BIF": (("B",), ()),
    "BEGL": (("S",), ()),
    "BEGR": (("S",), ("IL",)),
    "END": (("E",), ()),
}

TRNA_STRUCTURE = (
    "(((((((" + ".." + "((((" + "........" + "))))" + "." + "(((((" + "......."
    + ")))))" + "...." + "(((((" + "......." + ")))))" + ")))))))" + "."
)
# consensus positions (0-based) of the anticodon: bases 2:5 of the 7-base
# loop of the middle hairpin
TRNA_ANTICODON_AT = len("(((((((..((((........)))).(((((") + 2


@dataclass
class FixtureCM:
    name: str
    text: str            # the INFERNAL1/a section, up to and including "//"
    consensus: str       # consensus as DNA (ACGT), model coordinates
    structure: str       # dot-bracket, same coordinates
    n_states: int
    n_nodes: int

    @property
    def clen(self) -> int:
        return len(self.consensus)


# ------------------------------------------------------------- structures
def pair_table(structure: str) -> List[int]:
    """Partner of each position (-1 when unpaired)."""
    out = [-1] * len(structure)
    stack: List[int] = []
    for i, ch in enumerate(structure):
        if ch == "(":
            stack.append(i)
        elif ch == ")":
            j = stack.pop()
            out[i], out[j] = j, i
    if stack:
        raise ValueError("unbalanced structure")
    return out


def _hairpin(rng) -> str:
    stem = int(rng.integers(4, 9))
    return "(" * stem + "." * int(rng.integers(4, 9)) + ")" * stem


def _domain(rng) -> str:
    """A hairpin, or a stem around two or three hairpins (a multiloop)."""
    if rng.random() < 0.5:
        return _hairpin(rng)
    inner = "".join(
        "." * int(rng.integers(1, 4)) + _hairpin(rng)
        for _ in range(int(rng.integers(2, 4)))
    ) + "." * int(rng.integers(1, 4))
    stem = int(rng.integers(4, 8))
    return "(" * stem + inner + ")" * stem


def random_structure(rng, clen: int) -> str:
    """Domains separated by short unpaired linkers, exactly ``clen`` long."""
    out = "." * int(rng.integers(2, 6))
    while True:
        nxt = _domain(rng) + "." * int(rng.integers(2, 7))
        if len(out) + len(nxt) > clen:
            break
        out += nxt
    return out + "." * (clen - len(out))


def _seeded_consensus(rng, structure: str, fixed: Optional[Dict[int, str]]) -> str:
    pt = pair_table(structure)
    cons = [""] * len(structure)
    for i, j in enumerate(pt):
        if j < 0:
            cons[i] = RNA[int(rng.integers(0, 4))]
        elif i < j:
            # mostly Watson-Crick, an occasional G-U wobble
            k = int(rng.integers(0, 4)) if rng.random() < 0.9 else int(rng.integers(4, 6))
            cons[i], cons[j] = _PAIRS[k][0], _PAIRS[k][1]
    for i, ch in (fixed or {}).items():
        if pt[i] >= 0:
            raise ValueError("a fixed base must be unpaired")
        cons[i] = ch.replace("T", "U")
    return "".join(cons)


# --------------------------------------------------------------- model tree
def _model_tree(structure: str) -> List[dict]:
    """Nodes in preorder: dicts with ``kind``, ``left`` / ``right``
    consensus positions (or None) and, for BIF, ``right_node``."""
    pt = pair_table(structure)
    nodes: List[dict] = []

    def add(kind, left=None, right=None) -> int:
        nodes.append({"kind": kind, "left": left, "right": right})
        return len(nodes) - 1

    add("ROOT")
    # explicit stack of spans still to be laid out; a BIF pushes its right
    # branch below its left one so that the left subtree comes first
    stack: List[Tuple[int, int, Optional[int], str]] = [(0, len(structure) - 1, None, "")]
    while stack:
        i, j, bif, begin = stack.pop()
        if begin:
            idx = add(begin)
            if begin == "BEGR":
                nodes[bif]["right_node"] = idx
        while True:
            if i > j:
                add("END")
                break
            if pt[i] < 0:
                add("MATL", left=i)
                i += 1
            elif pt[j] < 0:
                add("MATR", right=j)
                j -= 1
            elif pt[i] == j:
                add("MATP", left=i, right=j)
                i, j = i + 1, j - 1
            else:
                b = add("BIF")
                k = pt[i]
                stack.append((k + 1, j, b, "BEGR"))
                stack.append((i, k, b, "BEGL"))
                break
    return nodes


def _max_depth(nodes: List[dict]) -> int:
    """Longest root-to-END chain of nodes (the recursion depth of the
    model-tree walks in ops/cyk.py)."""
    depth = [0] * len(nodes)
    best = 0
    for n, nd in enumerate(nodes):
        if nd["kind"] == "BIF":
            depth[n + 1] = depth[n] + 1
            depth[nd["right_node"]] = depth[n] + 1
        elif nd["kind"] != "END":
            depth[n + 1] = depth[n] + 1
        best = max(best, depth[n])
    return best


# ----------------------------------------------------------------- scores
def _bits(p: float) -> float:
    return math.log2(p)


def _single_scores(rng, base: str, peak: float) -> List[float]:
    other = (1.0 - peak) / 3
    return [_bits((peak if c == base else other) / 0.25) + float(rng.uniform(-0.1, 0.1))
            for c in RNA]


def _pair_scores(rng, left: str, right: str) -> List[float]:
    out = []
    for a in RNA:
        for b in RNA:
            if a == left and b == right:
                p = 0.70
            elif a + b in _PAIRS:
                p = 0.03
            else:
                p = 0.015
            out.append(_bits(p * 16) + float(rng.uniform(-0.1, 0.1)))
    return out


def _transition_scores(rng, parent: str, kids: List[str], self_idx: Optional[int]) -> List[float]:
    """log2 probabilities towards ``kids`` (state type names, in child
    order): the consensus state of the next node takes most of the mass."""
    probs = []
    main = next(i for i, k in enumerate(kids) if k not in ("IL", "IR"))
    for i, k in enumerate(kids):
        if i == self_idx:
            probs.append(0.25)
        elif k in ("IL", "IR"):
            probs.append(0.01)
        elif i == main:
            probs.append(0.0)        # filled below
        elif k == "D" and parent == "D":
            probs.append(0.40)
        else:
            probs.append(0.01)
    probs[main] = 1.0 - sum(probs)
    return [_bits(p) + float(rng.uniform(-0.02, 0.02)) for p in probs]


def _fmt(v: float) -> str:
    return f"{v:.3f}"


# ------------------------------------------------------------------ the CM
def build_cm(name: str, rng, structure: str,
             fixed: Optional[Dict[int, str]] = None) -> FixtureCM:
    """The CM section for ``structure`` with a consensus drawn from ``rng``
    (``fixed``: unpaired consensus position -> base, e.g. an anticodon)."""
    cons = _seeded_consensus(rng, structure, fixed)
    nodes = _model_tree(structure)
    if _max_depth(nodes) > 600:
        raise ValueError("model tree too deep for the recursive tree walks")
    # state ids in file order
    first_state = []
    sid = 0
    for nd in nodes:
        first_state.append(sid)
        split, ins = _NODE_STATES[nd["kind"]]
        sid += len(split) + len(ins)
    n_states = sid

    lines: List[str] = []
    for n, nd in enumerate(nodes):
        kind = nd["kind"]
        split, ins = _NODE_STATES[kind]
        cl = cons[nd["left"]] if nd["left"] is not None else "-"
        cr = cons[nd["right"]] if nd["right"] is not None else "-"
        ml = str(nd["left"] + 1) if nd["left"] is not None else "-"
        mr = str(nd["right"] + 1) if nd["right"] is not None else "-"
        lines.append(f"{'':39}[ {kind:4} {n:4d} ] {ml:>6} {mr:>6} {cl} {cr} "
                     f"{'x' if cl != '-' else '-'} {'x' if cr != '-' else '-'}")
        states = list(split) + list(ins)
        base = first_state[n]
        for si, st in enumerate(states):
            v = base + si
            if st == "B":
                cfirst, cnum = first_state[n + 1], first_state[nd["right_node"]]
                kids: List[str] = []
                self_idx = None
            elif st == "E":
                cfirst, cnum = -1, 0
                kids, self_idx = [], None
            else:
                nxt = _NODE_STATES[nodes[n + 1]["kind"]][0]
                if st in split:
                    own = list(ins)
                    cfirst = base + len(split) if ins else first_state[n + 1]
                else:
                    own = list(ins[ins.index(st):])
                    cfirst = v
                kids = own + list(nxt)
                cnum = len(kids)
                self_idx = 0 if st in ins else None
            trans = _transition_scores(rng, st, kids, self_idx) if kids else []
            if st == "MP":
                emit = _pair_scores(rng, cl, cr)
            elif st == "ML":
                emit = _single_scores(rng, cl, 0.85 if kind == "MATL" else 0.6)
            elif st == "MR":
                emit = _single_scores(rng, cr, 0.85 if kind == "MATR" else 0.6)
            elif st in ("IL", "IR"):
                emit = [0.0] * 4
            else:
                emit = []
            lines.append(
                f"    {st:>2} {v:5d} {max(v - 1, -1):5d} {1 if v else 0} "
                f"{cfirst:5d} {cnum:5d} {0:5d} {0:5d} {len(cons):5d} {len(cons):5d} "
                + " ".join(f"{_fmt(x):>7}" for x in trans + emit)
            )

    clen = len(cons)
    window = int(clen * 1.5) + 10
    head = [
        "INFERNAL1/a [1.1.4 | Dec 2020]",
        f"NAME     {name}",
        f"STATES   {n_states}",
        f"NODES    {len(nodes)}",
        f"CLEN     {clen}",
        f"W        {window}",
        "ALPH     RNA",
        "RF       no",
        "CONS     yes",
        "MAP      yes",
        "PBEGIN   0.05",
        "PEND     0.05",
        "WBETA    1e-07",
        "QDBBETA1 1e-07",
        "QDBBETA2 1e-15",
        "N2OMEGA  1.52588e-05",
        "N3OMEGA  1.52588e-05",
        "ELSELF   -0.08926734",
        "NSEQ     1",
        "EFFN     1.000000",
        "NULL     0.000  0.000  0.000  0.000",
        "EFP7GF   -6.4412 0.71858",
        # lambda, mu_extrap, mu_orig, dbsize, nhits, tailp
        "ECMLC    0.62369   -8.95393    0.81613     1600000      531557  0.002258",
        "ECMGC    0.42792  -14.49103   -3.20105     1600000       50012  0.007998",
        "ECMLI    0.53383   -8.38474    2.25076     1600000      350673  0.003422",
        "ECMGI    0.47628   -9.31019    0.57693     1600000       44378  0.009013",
        "CM",
    ]
    text = "\n".join(head + lines + ["//"]) + "\n"
    return FixtureCM(name, text, cons.replace("U", "T"), structure, n_states,
                     len(nodes))


def trna_cm(name: str, rng, anticodon: str) -> FixtureCM:
    """A cloverleaf whose anticodon loop carries ``anticodon`` (DNA or RNA
    letters, 5' to 3') at loop positions 2:5."""
    fixed = {TRNA_ANTICODON_AT + i: ch for i, ch in enumerate(anticodon.upper())}
    return build_cm(name, rng, TRNA_STRUCTURE, fixed)


def rrna_cm(name: str, rng, clen: int = 950) -> FixtureCM:
    return build_cm(name, rng, random_structure(rng, clen))


def write_cm(fx: FixtureCM, path: str) -> str:
    """Write the CM section followed by its filter profile (a HMMER3 model
    of the consensus, named like the CM) to ``path``."""
    filt = hmm_text.profile_from_consensus(fx.name, fx.consensus)
    with open(path, "w") as f:
        f.write(fx.text + hmm_text.hmm_text([filt]))
    return path
