"""A configuration's mitogenome and profile set, made from its own seed.

An extended copy of the port's ``testing/profile_fixture.py``: the genes of
the configuration's ``mitogenome`` section (protein-coding genes of given
lengths, tRNAs of given anticodons, rRNAs of given consensus lengths) are
laid out in its gene order on its strands with random spacers, and a
profile directory in the layout MitoFlex reads is written beside them:

    CDS_HMM/<clade>.hmm, CDS_HMM/required_cds.json   a profile HMM a PCG
    MT_database/<clade>.fa                           PCG translations x taxa
    tRNA_CM/<clade>_<key>.cm, rRNA_CM/{12s,16s}.cm   covariance models
    codes.json                                       clade -> genetic code

A PCG is ``ATG`` plus random codons that are not stops; its profile is
built from its exact sequence. The protein database holds, for each PCG,
one translation per taxon with a share of its residues (from ``divergence``,
spread evenly over the taxa) changed to another amino acid. tRNA and rRNA
consensus sequences are planted as they are, on their strands.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import cm_models, codes, hmm_text

AMINO = "ACDEFGHIKLMNPQRSTVWY"
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
RRNA_FILES = {"rrnS": "12s", "rrnL": "16s"}


@dataclass
class Mitogenome:
    profile_dir: str
    clade: str
    genetic_code: int
    genome: str
    # gene -> (start, end, strand, kind); 0-based half-open; kind 0 PCG,
    # 1 tRNA (named trn<key>, e.g. trnL1), 2 rRNA
    genes: Dict[str, Tuple[int, int, int, int]]
    pcg_nt: Dict[str, str]

    @property
    def hmm_lengths(self) -> Dict[str, int]:
        return {g: len(nt) for g, nt in self.pcg_nt.items()}


def random_dna(rng: np.random.Generator, n: int) -> str:
    return BASES[rng.integers(0, 4, size=n)].tobytes().decode()


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _orf(rng, n_nt: int, table: Dict[str, str]) -> str:
    if n_nt % 3:
        raise ValueError(f"a PCG length must be a multiple of 3, not {n_nt}")
    sense = sorted(c for c, a in table.items() if a != "*")
    picks = rng.integers(0, len(sense), n_nt // 3 - 1)
    return "ATG" + "".join(sense[int(i)] for i in picks)


def _diverge(rng, pep: str, share: float) -> str:
    out = list(pep)
    n = int(round(share * len(out)))
    for i in rng.choice(np.arange(1, len(out)), size=min(n, len(out) - 1), replace=False):
        out[i] = AMINO[(AMINO.index(out[i]) + int(rng.integers(1, 20))) % 20]
    return "".join(out)


def build(spec: dict, out_dir: str) -> Mitogenome:
    """The mitogenome and profile set of ``spec`` (a configuration's
    ``mitogenome`` section) from its ``seed``, written under ``out_dir``."""
    rng = np.random.default_rng([int(spec["seed"]), 0x6D69746F])
    clade, gcode = spec["clade"], int(spec["genetic_code"])
    table = codes.table(gcode)
    pdir = os.path.join(out_dir, "profile")
    for sub in ("CDS_HMM", "MT_database", "tRNA_CM", "rRNA_CM"):
        os.makedirs(os.path.join(pdir, sub), exist_ok=True)

    pcg_nt = {g: _orf(rng, int(n), table) for g, n in spec["pcg_lengths"].items()}
    rna_seq: Dict[str, str] = {}
    for key, codon in spec["trna_codons"].items():
        if table[codon] != key[0]:
            raise ValueError(f"codon {codon} of trn{key} reads {table[codon]} under "
                             f"table {gcode}")
        fx = cm_models.trna_cm(f"{clade}_{key}", rng, revcomp(codon))
        cm_models.write_cm(fx, os.path.join(pdir, "tRNA_CM", f"{clade}_{key}.cm"))
        rna_seq[f"trn{key}"] = fx.consensus
    for name, clen in spec["rrna_clen"].items():
        fx = cm_models.rrna_cm(RRNA_FILES[name], rng, int(clen))
        cm_models.write_cm(fx, os.path.join(pdir, "rRNA_CM", f"{RRNA_FILES[name]}.cm"))
        rna_seq[name] = fx.consensus

    lo, hi = spec["spacer"]
    parts: List[str] = []
    genes: Dict[str, Tuple[int, int, int, int]] = {}
    pos = 0
    for name, strand in spec["gene_order"]:
        sp = random_dna(rng, int(rng.integers(lo, hi + 1)))
        parts.append(sp)
        pos += len(sp)
        if name in pcg_nt:
            seq, kind = pcg_nt[name], 0
        else:
            seq, kind = rna_seq[name], (2 if name in RRNA_FILES else 1)
        parts.append(seq if strand > 0 else revcomp(seq))
        genes[name] = (pos, pos + len(seq), int(strand), kind)
        pos += len(seq)
    parts.append(random_dna(rng, int(spec["control_region"])))
    genome = "".join(parts)
    unplaced = (set(pcg_nt) | set(rna_seq)) - set(genes)
    if unplaced:
        raise ValueError(f"genes without a place in gene_order: {sorted(unplaced)}")

    hmms = [hmm_text.profile_from_consensus(g, nt) for g, nt in pcg_nt.items()]
    with open(os.path.join(pdir, "CDS_HMM", f"{clade}.hmm"), "w") as f:
        f.write(hmm_text.hmm_text(hmms))
    with open(os.path.join(pdir, "CDS_HMM", "required_cds.json"), "w") as f:
        json.dump({clade: {g: len(nt) for g, nt in pcg_nt.items()}}, f)
    with open(os.path.join(pdir, "codes.json"), "w") as f:
        json.dump({clade: gcode}, f)
    taxa = spec["protein_taxa"]
    d_lo, d_hi = spec["divergence"]
    lines = []
    for ti, taxon in enumerate(taxa):
        share = d_lo + (d_hi - d_lo) * ti / max(len(taxa) - 1, 1)
        for g, nt in pcg_nt.items():
            pep = _diverge(rng, codes.translate(nt, gcode).rstrip("*"), share)
            lines.append(f">gi_NC_{100001 + ti:06d}_{g}_{taxon}_{len(pep)}_aa\n{pep}\n")
    with open(os.path.join(pdir, "MT_database", f"{clade}.fa"), "w") as f:
        f.write("".join(lines))
    return Mitogenome(pdir, clade, gcode, genome, genes, pcg_nt)
