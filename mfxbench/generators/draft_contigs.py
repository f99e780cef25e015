"""A draft WGS assembly in megahit's FASTA form, with the mitogenome in it.

Nuclear contigs of log-normal length (``length_median``, ``length_sigma``,
clipped to ``length_clip``) are drawn until they hold ``nuclear_bases``;
each is random sequence at a ``multi`` drawn uniformly from ``nuclear_multi``.
The mitogenome is one more contig at ``mito_multi``, as megahit writes a
circle: its first ``circle_overlap`` bases repeated at its end. The contigs
are shuffled, named ``k141_<i>`` and written one sequence line each, with
megahit's ``flag= multi= len=`` description (``flag`` as the port's own
assembler writes it: 1 for the circle, 0 for a linear contig).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .mitogenome import Mitogenome

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class ContigTruth:
    mito_id: str
    n_contigs: int


def generate(mito: Mitogenome, params: dict, seed: int, index: int, out_dir: str):
    """Sample ``index`` of the pool: writes ``contigs.fa`` under
    ``out_dir``; returns (inputs, input bases, truth)."""
    rng = np.random.default_rng([seed, index, 0x64726674])
    lo, hi = params["length_clip"]
    total = int(params["nuclear_bases"])
    lengths = []
    held = 0
    while held < total:
        draw = np.exp(rng.normal(np.log(params["length_median"]), params["length_sigma"], 4096))
        for n in np.clip(np.rint(draw), lo, hi).astype(np.int64):
            n = int(min(n, total - held)) if total - held >= lo else int(n)
            lengths.append(n)
            held += n
            if held >= total:
                break
    seq = BASES[rng.integers(0, 4, held)]
    m_lo, m_hi = params["nuclear_multi"]
    multis = rng.uniform(m_lo, m_hi, len(lengths))
    circle = mito.genome + mito.genome[: int(params["circle_overlap"])]
    order = rng.permutation(len(lengths) + 1)
    mito_at = int(np.nonzero(order == len(lengths))[0][0])
    ends = np.cumsum(lengths)
    lines = []
    for pos, item in enumerate(order):
        name = f"k141_{pos}"
        if item == len(lengths):
            s, flag, multi = circle, 1, float(params["mito_multi"])
        else:
            s = seq[ends[item] - lengths[item]: ends[item]].tobytes().decode()
            flag, multi = 0, float(multis[item])
        lines.append(f">{name} flag={flag} multi={multi:.4f} len={len(s)}\n{s}\n")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "contigs.fa")
    with open(path, "w") as f:
        f.write("".join(lines))
    truth = ContigTruth(f"k141_{mito_at}", len(order))
    return {"contigs": path}, held + len(circle), truth
